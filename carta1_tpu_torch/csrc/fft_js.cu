// K6: the reference's forward transforms on its radix-2 FFT: the MDCT and
// the transient detector's magnitude spectrum, bit-exact.
//
// Replaces carta1_tpu/gold/transforms.py mdct_js (:42) and
// carta1_tpu/gold/fftjs.py magnitude_spectrum_js (:94), both over fft_js
// (:57): NumPy on the host in the JAX package, which has no Pallas kernel
// for them.  The forward counterpart of K1 (csrc/imdct_exact.cu), with the
// same arithmetic: every f64 operation is one explicit round-to-nearest
// intrinsic (the build adds -fmad=false), every value the reference stores
// into a Float32Array is rounded to f32 at that point, and the twiddles
// and sincos tables are the host's (tables.mdct_tables, fft_tables: the
// reference's f64 recurrence, never device sin/cos).
//
//   mode 0, MDCT of size 4N (mdct.js:54-122): rows of 4N f32 samples ->
//     rows of 2N coefficients.  Pre-FFT butterfly over two regions into N
//     complex points (stored f32, at their bit-reversed positions), the N-
//     point FFT (fft.js:14-68: t = o * w, e +- t stored f32, each stage),
//     post-twiddle out[2i] = -re*c - im*s, out[2N-1-2i] = -re*s + im*c.
//     At N = 16 an optional mask selects the rows to transform: the others
//     are written as zeros and cost no arithmetic (the encoder keeps the
//     short MDCT of a frame only where its band's mode is short).
//   mode 1, magnitude spectrum of an N-point FFT (transient.js:17-35):
//     rows of N f32 samples (the real part; the imaginary part +0) ->
//     sqrt(re^2 + im^2) in f64 of the first N/2 bins, stored f32.
//
// Bound on this card: neither bytes (6-12 per output value) nor the f64
// arithmetic, but the f32 <-> f64 conversions that the per-stage stores
// cost: each of the 2N values of a row is widened and rounded once per
// stage (4N conversions per stage), plus the pre-twiddle's, post-twiddle's
// and magnitude's.  They run on a pipe of their own that retires a
// fraction of what the f64 adder does (chip_smoke.py measures the rate in
// the same run with the round-trip loop of csrc/probe_rates.cu; the two
// pipes overlap).  That count is fixed by the reference's arithmetic, so
// the design spends as little as it can beside it, as K1 does:
//   * rows enter and leave as 16-byte copies of whole rows (cp.async in,
//     float4 out), coalesced; the bit reversal and the output interleave
//     happen between shared memory and registers;
//   * MDCT of size 64 (16 points): one thread per transform, its row's 64
//     samples, 16 points and all four stages in registers; twiddles and
//     sincos are kernel parameters.  A block is one warp (32 rows), so no
//     block barrier waits; a warp whose rows are all masked off only
//     writes zeros;
//   * 64 to 256 points (MDCT 256 and 512, spectrum 128 and 256): N/8
//     threads per transform, 8 points each (a 256-point row is one warp's
//     32 threads).  A thread runs up to three consecutive radix-2 stages
//     on its 8 points, so 6 stages are 2 passes, 7 and 8 are 3.  Between
//     passes the points change hands through a padded exchange row in
//     shared memory that reuses the row's own staging space; a
//     transform's threads sit in one warp, so __syncwarp is the only
//     barrier between stages.  First-pass twiddles are kernel parameters;
//     later passes and the MDCT's sincos read per-block shared copies.
//     Blocks are 4 warps; a block waits once, for its tables, and each
//     warp then waits only for its own rows' copies, never for another
//     warp's.
#include "exact.cuh"

#include <cuda_pipeline_primitives.h>

namespace {

__device__ __forceinline__ double wide(float v) { return static_cast<double>(v); }

// One radix-2 DIT butterfly (fft.js:42-65): t = o * w, outputs RN32(e +- t).
__device__ __forceinline__ void butterfly(float& er, float& ei, float& orr, float& oi, double wr, double wi) {
  const double o_r = wide(orr), o_i = wide(oi), e_r = wide(er), e_i = wide(ei);
  const double t_r = __dsub_rn(__dmul_rn(o_r, wr), __dmul_rn(o_i, wi));
  const double t_i = __dadd_rn(__dmul_rn(o_r, wi), __dmul_rn(o_i, wr));
  er = rn32(__dadd_rn(e_r, t_r));
  orr = rn32(__dsub_rn(e_r, t_r));
  ei = rn32(__dadd_rn(e_i, t_i));
  oi = rn32(__dsub_rn(e_i, t_i));
}

// Pre-FFT butterfly of the MDCT of size 4N (mdct.js:70-96) for FFT element
// j (i = 2j) of a row of 4N samples; (c, s) is the sincos table's pair j.
template <int N, class Row>
__device__ __forceinline__ void mdct_pre(const Row& xi, int j, double c, double s, float& re, float& im) {
  constexpr int quarter = N, n34 = 3 * N;
  const int i = 2 * j;
  double a, b;
  if (i < quarter) {
    a = __dadd_rn(wide(xi[n34 - 1 - i]), wide(xi[n34 + i]));
    b = __dsub_rn(wide(xi[quarter + i]), wide(xi[quarter - 1 - i]));
  } else {
    a = __dsub_rn(wide(xi[n34 - 1 - i]), wide(xi[i - quarter]));
    b = __dadd_rn(wide(xi[quarter + i]), wide(xi[5 * quarter - 1 - i]));
  }
  re = rn32(__dadd_rn(__dmul_rn(a, c), __dmul_rn(b, s)));
  im = rn32(__dsub_rn(__dmul_rn(b, c), __dmul_rn(a, s)));
}

// Post-twiddle (mdct.js:103-118) of FFT output i into a row of 2N coefficients.
template <int N, class Row>
__device__ __forceinline__ void mdct_post(float re, float im, int i, double c, double s, Row& o) {
  const double rv = wide(re), iv = wide(im);
  o[2 * i] = rn32(__dsub_rn(__dmul_rn(-rv, c), __dmul_rn(iv, s)));
  o[2 * N - 1 - 2 * i] = rn32(__dadd_rn(__dmul_rn(-rv, s), __dmul_rn(iv, c)));
}

__host__ __device__ constexpr int bit_reverse(int v, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((v >> b) & 1) << (bits - 1 - b);
  return r;
}

// ---------------------------------------------------------------------------
// MDCT of size 64: one thread per 16-point transform, one warp per block.
// ---------------------------------------------------------------------------
struct Tables16 {
  double sincos[32];
  double tw_re[15], tw_im[15];
};
constexpr int kRows16 = 32;
constexpr int kStride16 = 68;   // floats per staged row: 16-byte accesses of 8 threads fall on 32 different banks

__global__ void __launch_bounds__(kRows16) mdct64_kernel(
    const float* __restrict__ x, float* __restrict__ out, const bool* __restrict__ active,
    const __grid_constant__ Tables16 tab, long long batch) {
  constexpr int N = 16, IN = 64, OUT = 32;
  __shared__ __align__(16) float tile[kRows16 * kStride16];
  const int lane = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows16;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows16), batch - b0));
  const bool on = lane < rows && (active == nullptr || active[b0 + lane]);
  const unsigned live = __ballot_sync(0xffffffffu, on);

  if (live != 0u) {
    for (int c = lane; c < rows * (IN / 4); c += 32) {
      const int r = c >> 4, q = c & 15;
      if ((live >> r) & 1u) __pipeline_memcpy_async(tile + r * kStride16 + 4 * q, x + b0 * IN + 4 * c, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    if (on) {
      float* row = tile + lane * kStride16;
      float v[IN];
#pragma unroll
      for (int q = 0; q < IN / 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(row + 4 * q);
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
      }
      float re[N], im[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {                     // element j at position bit_reverse(j)
        const int k = bit_reverse(j, 4);
        mdct_pre<N>(v, j, tab.sincos[2 * j], tab.sincos[2 * j + 1], re[k], im[k]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = 1 << q;
#pragma unroll
        for (int p = 0; p < N / 2; ++p) {
          const int g = p / h, k = p - g * h, ie = g * 2 * h + k, io = ie + h;
          butterfly(re[ie], im[ie], re[io], im[io], tab.tw_re[h - 1 + k], tab.tw_im[h - 1 + k]);
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) mdct_post<N>(re[i], im[i], i, tab.sincos[2 * i], tab.sincos[2 * i + 1], v);
#pragma unroll
      for (int q = 0; q < OUT / 4; ++q)
        *reinterpret_cast<float4*>(row + 4 * q) = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncwarp();
  }

  for (int c = lane; c < rows * (OUT / 4); c += 32) {
    const int r = c >> 3, q = c & 7;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if ((live >> r) & 1u) val = *reinterpret_cast<const float4*>(tile + r * kStride16 + 4 * q);
    *reinterpret_cast<float4*>(out + b0 * OUT + 4 * c) = val;
  }
}

// ---------------------------------------------------------------------------
// 64 to 256 points: N/8 threads per transform, 8 points per thread.
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;

// The twiddles of the stages with stride 2, 4 and 8 (entries 0, 1-2, 3-6 of the stage table).
struct FirstTwiddles {
  double re[7], im[7];
};

template <int MODE, int N>
struct Shape {
  static constexpr int BITS = N == 64 ? 6 : N == 128 ? 7 : 8;
  static constexpr int T = N / 8;                        // threads per transform
  static constexpr int ROWS_PER_WARP = 32 / T;
  static constexpr int TILE = kThreads / T;              // transforms per block
  static constexpr int IN = MODE == 0 ? 4 * N : N;       // floats per input row
  static constexpr int OUT = MODE == 0 ? 2 * N : N / 2;  // floats per output row
  static constexpr int PT = N + N / 8;                   // float2 slots of an exchange row: one pad per 8 points
  // floats per staged row: the input, then the exchange row over it, then the output; neighbouring rows 16 banks apart
  static constexpr int ROWF = (IN > 2 * PT ? IN : 2 * PT) + 16;
  static constexpr int LAST_B = BITS > 6 ? 6 : 3;        // the last pass's first stage
};

// Exchange-row slot of FFT position p.
__device__ __forceinline__ int slot(int p) { return p + (p >> 3); }

// Position of a thread's value number v in the pass that works on the
// position bits [B, B + NB): the thread holds 8 >> NB groups of 1 << NB
// values, the values of a group differing in those bits only.  `rest`
// spreads over the other bits, the thread's index lowest, so that
// neighbouring threads sit on neighbouring positions.
template <int BITS, int B, int NB>
__device__ __forceinline__ int position(int j, int v) {
  const int m = v & ((1 << NB) - 1), g = v >> NB;
  const int rest = (g << (BITS - 3)) | j;
  const int low = rest & ((1 << B) - 1), high = rest >> B;
  return (high << (B + NB)) | (m << B) | low;
}

// Stages B .. B + NB - 1 on a thread's 8 values.  The twiddle of stage q at
// position p is entry (1 << q) - 1 + (p mod (1 << q)) of the stage table.
template <int BITS, int B, int NB>
__device__ __forceinline__ void run_pass(float (&re)[8], float (&im)[8], int j, const FirstTwiddles& first,
                                         const double2* __restrict__ tw) {
#pragma unroll
  for (int lb = 0; lb < NB; ++lb) {
    const int q = B + lb;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (v & (1 << lb)) continue;
      double wr, wi;
      if constexpr (B == 0) {
        wr = first.re[(1 << q) - 1 + (v & ((1 << q) - 1))];   // compile-time index: k = v mod (1 << q)
        wi = first.im[(1 << q) - 1 + (v & ((1 << q) - 1))];
      } else {
        const double2 w = tw[(1 << q) - 1 + (position<BITS, B, NB>(j, v) & ((1 << q) - 1))];
        wr = w.x, wi = w.y;
      }
      butterfly(re[v], im[v], re[v | (1 << lb)], im[v | (1 << lb)], wr, wi);
    }
  }
}

template <int BITS, int B, int NB>
__device__ __forceinline__ void load_points(const float2* pts, int j, float (&re)[8], float (&im)[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float2 f = pts[slot(position<BITS, B, NB>(j, v))];
    re[v] = f.x, im[v] = f.y;
  }
}

template <int BITS, int B, int NB>
__device__ __forceinline__ void store_points(float2* pts, int j, const float (&re)[8], const float (&im)[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) pts[slot(position<BITS, B, NB>(j, v))] = make_float2(re[v], im[v]);
}

// A minimum of one block per SM leaves ptxas free to keep more of a
// thread's values in registers than its default for 128-thread blocks; the
// MDCT's pre-twiddle and passes run faster so, the spectrum as fast.
template <int MODE, int N>
__global__ void __launch_bounds__(kThreads, 1) fftjs_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const double* __restrict__ sincos,   // mode 0: [2N] interleaved (cos, sin), mdct.js:20-38
    const double* __restrict__ tw_re,    // [N - 1] stage twiddles from the f64 recurrence
    const double* __restrict__ tw_im, const __grid_constant__ FirstTwiddles first, long long batch) {
  using S = Shape<MODE, N>;
  constexpr int BITS = S::BITS, T = S::T, IN = S::IN, OUT = S::OUT, ROWF = S::ROWF;
  __shared__ __align__(16) float io[S::TILE * ROWF];
  __shared__ double2 s_tw[N];
  __shared__ double2 s_sc[MODE == 0 ? N : 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's rows: one contiguous span of x and of out
  const long long row0 = static_cast<long long>(blockIdx.x) * S::TILE + warp * S::ROWS_PER_WARP;
  const int rows = static_cast<int>(max(0LL, min(static_cast<long long>(S::ROWS_PER_WARP), batch - row0)));
  float* my_io = io + warp * S::ROWS_PER_WARP * ROWF;
  constexpr int CHUNKS_IN = IN / 4, CHUNKS_OUT = OUT / 4;    // 16-byte chunks per row

  for (int c = lane; c < rows * CHUNKS_IN; c += 32) {
    const int r = c / CHUNKS_IN, q = c % CHUNKS_IN;
    __pipeline_memcpy_async(my_io + r * ROWF + 4 * q, x + row0 * IN + 4 * c, 16);
  }
  __pipeline_commit();
  if constexpr (MODE == 0)
    for (int t = threadIdx.x; t < N; t += kThreads) s_sc[t] = make_double2(sincos[2 * t], sincos[2 * t + 1]);
  for (int t = threadIdx.x; t < N - 1; t += kThreads) s_tw[t] = make_double2(tw_re[t], tw_im[t]);
  __syncthreads();                                               // the tables are in, block-wide
  __pipeline_wait_prior(0);                                      // this warp's rows, warp-wide: no warp waits on
  __syncwarp();                                                  // another warp's copies

  const int r = lane / T, j = lane % T;                          // transform within the warp, thread within it
  const bool active = r < rows;
  float* row = my_io + r * ROWF;
  float2* pts = reinterpret_cast<float2*>(row);                  // the exchange row lies over the staged samples
  float re[8], im[8];

  // the first pass's positions 8j .. 8j+7; position k holds element bit_reverse(k)
  if (active) {
    const int jr = __brev(j) >> (32 - (BITS - 3));
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int e = (bit_reverse(v, 3) << (BITS - 3)) | jr;
      if constexpr (MODE == 0) {
        const double2 cs = s_sc[e];
        mdct_pre<N>(row, e, cs.x, cs.y, re[v], im[v]);
      } else {
        re[v] = row[e];
        im[v] = 0.0f;
      }
    }
    run_pass<BITS, 0, 3>(re, im, j, first, s_tw);
  }
  __syncwarp();                                                  // the row's samples are read
  if (active) store_points<BITS, 0, 3>(pts, j, re, im);
  __syncwarp();
  if (active) {
    load_points<BITS, 3, 3>(pts, j, re, im);
    run_pass<BITS, 3, 3>(re, im, j, first, s_tw);
  }
  if constexpr (BITS > 6) {
    if (active) store_points<BITS, 3, 3>(pts, j, re, im);        // the slots this thread read itself
    __syncwarp();
    if (active) {
      load_points<BITS, 6, BITS - 6>(pts, j, re, im);
      run_pass<BITS, 6, BITS - 6>(re, im, j, first, s_tw);
    }
  }
  __syncwarp();                                                  // every point is read: outputs may overwrite the row
  if (active) {
    constexpr int LB = S::LAST_B, NBL = BITS - LB;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int i = position<BITS, LB, NBL>(j, v);                // natural order after the last stage
      if constexpr (MODE == 0) {
        const double2 cs = s_sc[i];
        mdct_post<N>(re[v], im[v], i, cs.x, cs.y, row);
      } else if (i < N / 2) {
        const double rv = wide(re[v]), iv = wide(im[v]);
        row[i] = rn32(__dsqrt_rn(__dadd_rn(__dmul_rn(rv, rv), __dmul_rn(iv, iv))));
      }
    }
  }
  __syncwarp();

  for (int c = lane; c < rows * CHUNKS_OUT; c += 32) {
    const int r2 = c / CHUNKS_OUT, q = c % CHUNKS_OUT;
    *reinterpret_cast<float4*>(out + row0 * OUT + 4 * c) = *reinterpret_cast<const float4*>(my_io + r2 * ROWF + 4 * q);
  }
}

template <int MODE, int N>
void launch(const float* x, float* out, const double* sincos, const double* tw_re, const double* tw_im,
            const FirstTwiddles& first, long long batch, cudaStream_t stream) {
  constexpr int TILE = Shape<MODE, N>::TILE;
  const long long blocks = (batch + TILE - 1) / TILE;
  fftjs_kernel<MODE, N><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(x, out, sincos, tw_re, tw_im,
                                                                                    first, batch);
}

}  // namespace

// mode 0: the MDCT of size 4n (n = 16, 64, 128), x [batch, 4n] -> out [batch, 2n];
// mode 1: the magnitude spectrum of an n-point FFT (n = 128, 256), x [batch, n] -> out [batch, n/2].
// x and out 16-byte aligned.  active: bool [batch] on the card or null (mode 0, n = 16 only): rows
// whose flag is false are written as zeros.  sincos (mode 0 only), tw_re, tw_im: tables.mdct_tables(4n)
// / fft_tables(n) on the card; host_*: the same tables in host memory, read during the call.
extern "C" int carta1_fftjs(const float* x, float* out, const bool* active, const double* sincos,
                            const double* tw_re, const double* tw_im, const double* host_sincos,
                            const double* host_tw_re, const double* host_tw_im, long long batch, int mode, int n,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0 && n == 16) {
    Tables16 tab;
    for (int i = 0; i < 32; ++i) tab.sincos[i] = host_sincos[i];
    for (int i = 0; i < 15; ++i) tab.tw_re[i] = host_tw_re[i], tab.tw_im[i] = host_tw_im[i];
    const long long blocks = (batch + kRows16 - 1) / kRows16;
    mdct64_kernel<<<static_cast<unsigned int>(blocks), kRows16, 0, st>>>(x, out, active, tab, batch);
    return static_cast<int>(cudaGetLastError());
  }
  if (active != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  FirstTwiddles first;
  for (int i = 0; i < 7; ++i) first.re[i] = host_tw_re[i], first.im[i] = host_tw_im[i];
  if (mode == 0 && n == 64) launch<0, 64>(x, out, sincos, tw_re, tw_im, first, batch, st);
  else if (mode == 0 && n == 128) launch<0, 128>(x, out, sincos, tw_re, tw_im, first, batch, st);
  else if (mode == 1 && n == 128) launch<1, 128>(x, out, sincos, tw_re, tw_im, first, batch, st);
  else if (mode == 1 && n == 256) launch<1, 256>(x, out, sincos, tw_re, tw_im, first, batch, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
