// K1: bit-exact IMDCT (mdct.js:139-211, fft.js:14-68), middle half only.
//
// Replaces the Pallas kernel carta1_tpu/ops/exact_fft_pallas.py
// (_imdct_core_call, body _core_body), which emulates f64 with f32
// error-free expansions because the TPU has no IEEE f64.  Hopper has f64,
// so this kernel mirrors the gold engine (carta1_tpu/gold/transforms.py
// imdct_js, gold/fftjs.py fft_js) operation for operation: each product
// and sum is one f64 op rounded to nearest, and each value the reference
// stores into a Float32Array is rounded to f32 at that point (after the
// pre-twiddle, after every radix-2 stage, after the post-twiddle).  A
// value lives in a register as that f32 and is widened, exactly, where
// the next butterfly reads it.
//
// Layout: x is [batch, size/2] f32 spectra, out is [batch, size/2] f32,
// the middle half [size/4, 3size/4) of the size-sample output -- the only
// part the decoder's overlap assembly reads.  N = size/4 complex points.
//
// Bound on this card: at sizes 256 and 512 neither bytes (8 per coefficient)
// nor the f64 arithmetic (21-24 ops per coefficient) but the conversions
// that the per-stage f32 store costs: one rounding and one widening per
// value per stage, on a pipe of their own that retires a quarter of what
// the f64 adder does (carta1_tpu_torch/probe_rates.py measures both; the
// two pipes overlap).  That count is fixed by the reference's arithmetic,
// so the design spends nothing else beside it; at size 64 the launch
// itself is the time.  What a kernel can waste on top is a trip of the
// working set through shared memory with a block-wide barrier per stage,
// scattered 4-byte device accesses and table loads from device memory;
// the design avoids each:
//   * rows enter and leave as 16-byte copies of whole rows (cp.async in,
//     float4 out), coalesced; the bit reversal and the output interleave
//     happen between shared memory and registers;
//   * size 64: one thread per transform.  The 32 inputs, the 16 complex
//     points and all four stages stay in its registers; twiddles and
//     sincos are kernel parameters, i.e. constant-bank operands.  A block
//     is one warp (32 rows), so nothing waits on a block-wide barrier and
//     a chunk's few thousand short blocks spread over every SM;
//   * sizes 256 and 512: N/8 threads per transform, 8 points each.  A
//     thread runs up to three consecutive stages on its 8 points (the same
//     radix-2 butterflies, the same rounding after each stage), so 6
//     stages are 2 passes and 7 are 3.  Between passes the points change
//     hands through a padded shared-memory row; a transform's threads sit
//     in one warp, so __syncwarp is the only barrier between stages, and a
//     warp loads, transforms and stores its own rows while other warps are
//     at other steps.  First-pass twiddles are kernel parameters; later
//     passes and the pre/post sincos read per-block shared-memory copies.
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

// Pre-twiddle (mdct.js:149-157) of element i: r = -x[2i], s = -x[half-1-2i];
// gold evaluates re = s*sin + r*cos, im = s*cos - r*sin.
__device__ __forceinline__ void pre_twiddle(float x_even, float x_odd, double c, double sn, float& re, float& im) {
  const double r = -wide(x_even), s = -wide(x_odd);
  re = rn32(__dadd_rn(__dmul_rn(s, sn), __dmul_rn(r, c)));
  im = rn32(__dsub_rn(__dmul_rn(s, c), __dmul_rn(r, sn)));
}

// Post-twiddle (mdct.js:168-205): r1 = re*cos + im*sin, i1 = re*sin - im*cos.
// Inside the middle half, i1[i] lands at 2i and r1[i] at half-1-2i.
__device__ __forceinline__ void post_twiddle(float re, float im, double c, double sn, float& r1, float& i1) {
  const double rv = wide(re), iv = wide(im);
  r1 = rn32(__dadd_rn(__dmul_rn(rv, c), __dmul_rn(iv, sn)));
  i1 = rn32(__dsub_rn(__dmul_rn(rv, sn), __dmul_rn(iv, c)));
}

__host__ __device__ constexpr int bit_reverse(int v, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((v >> b) & 1) << (bits - 1 - b);
  return r;
}

// The twiddles of the stages with stride 2, 4 and 8 (indices 0, 1-2, 3-6
// of the stage table) and, for size 64 only, the whole of its tables.
struct FirstTwiddles {
  double re[7], im[7];
};
struct Tables64 {
  double sincos[32];
  double tw_re[15], tw_im[15];
};

// ---------------------------------------------------------------------------
// Size 64: one thread per 16-point transform, one warp per block.
// ---------------------------------------------------------------------------
constexpr int kRows64 = 32;
constexpr int kStride64 = 36;   // floats per shared row: 16-byte reads of 8 threads fall on 32 different banks

__global__ void __launch_bounds__(kRows64) imdct64_kernel(
    const float* __restrict__ x, float* __restrict__ out, const __grid_constant__ Tables64 tab, int batch) {
  constexpr int N = 16, HALF = 32;
  __shared__ __align__(16) float tile[kRows64 * kStride64];
  const int lane = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows64;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows64), batch - b0));

  for (int c = lane; c < rows * (HALF / 4); c += 32) {
    const int r = c >> 3, q = c & 7;
    __pipeline_memcpy_async(tile + r * kStride64 + 4 * q, x + b0 * HALF + 4 * c, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  if (lane < rows) {
    float* row = tile + lane * kStride64;
    float v[HALF];
#pragma unroll
    for (int q = 0; q < HALF / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(row + 4 * q);
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
    }
    float re[N], im[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {                       // position k holds element i: the FFT's bit reversal
      const int i = bit_reverse(k, 4);
      pre_twiddle(v[2 * i], v[HALF - 1 - 2 * i], tab.sincos[2 * i], tab.sincos[2 * i + 1], re[k], im[k]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = 1 << q;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const int g = j / h, k = j - g * h, ie = g * 2 * h + k, io = ie + h;
        butterfly(re[ie], im[ie], re[io], im[io], tab.tw_re[h - 1 + k], tab.tw_im[h - 1 + k]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      post_twiddle(re[i], im[i], tab.sincos[2 * i], tab.sincos[2 * i + 1], v[HALF - 1 - 2 * i], v[2 * i]);
#pragma unroll
    for (int q = 0; q < HALF / 4; ++q)
      *reinterpret_cast<float4*>(row + 4 * q) = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncwarp();

  for (int c = lane; c < rows * (HALF / 4); c += 32) {
    const int r = c >> 3, q = c & 7;
    *reinterpret_cast<float4*>(out + b0 * HALF + 4 * c) = *reinterpret_cast<const float4*>(tile + r * kStride64 + 4 * q);
  }
}

// ---------------------------------------------------------------------------
// Sizes 256 and 512: N/8 threads per transform, 8 points per thread.
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;

template <int SIZE>
struct Shape {
  static constexpr int HALF = SIZE / 2;
  static constexpr int N = SIZE / 4;                     // FFT points
  static constexpr int BITS = N == 64 ? 6 : 7;
  static constexpr int T = N / 8;                        // threads per transform
  static constexpr int TILE = kThreads / T;              // transforms per block: 16 KB of rows
  static constexpr int ROWS_PER_WARP = 32 / T;
  static constexpr int IO_STRIDE = HALF + 16;            // floats per staged row: neighbouring rows 16 banks apart
  static constexpr int PT_STRIDE = N + N / 8;            // float2 per exchange row: one pad per 8 points
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
      const int k = position<BITS, B, NB>(j, v) & ((1 << q) - 1);
      double wr, wi;
      if constexpr (B == 0) {
        wr = first.re[(1 << q) - 1 + (v & ((1 << q) - 1))];   // compile-time index: k = v mod (1 << q)
        wi = first.im[(1 << q) - 1 + (v & ((1 << q) - 1))];
      } else {
        const double2 w = tw[(1 << q) - 1 + k];
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

template <int SIZE>
__global__ void __launch_bounds__(kThreads) imdct_mid_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const double* __restrict__ sincos,   // [HALF] interleaved (cos, sin), mdct.js:20-38
    const double* __restrict__ tw_re,    // [N-1] stage twiddles from the f64 recurrence
    const double* __restrict__ tw_im, const __grid_constant__ FirstTwiddles first, int batch) {
  using S = Shape<SIZE>;
  constexpr int HALF = S::HALF, N = S::N, BITS = S::BITS, T = S::T;
  __shared__ __align__(16) float io[S::TILE * S::IO_STRIDE];     // rows as they come and as they leave
  __shared__ float2 points[S::TILE * S::PT_STRIDE];              // complex points between passes
  __shared__ double2 s_sincos[N];
  __shared__ double2 s_tw[N];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's rows: one contiguous 2 KB span of x and of out
  const long long row0 = static_cast<long long>(blockIdx.x) * S::TILE + warp * S::ROWS_PER_WARP;
  const int rows = static_cast<int>(max(0LL, min(static_cast<long long>(S::ROWS_PER_WARP), batch - row0)));
  float* my_io = io + warp * S::ROWS_PER_WARP * S::IO_STRIDE;
  constexpr int CHUNKS = HALF / 4;                               // 16-byte chunks per row

  for (int c = lane; c < rows * CHUNKS; c += 32) {
    const int r = c / CHUNKS, q = c % CHUNKS;
    __pipeline_memcpy_async(my_io + r * S::IO_STRIDE + 4 * q, x + row0 * HALF + 4 * c, 16);
  }
  __pipeline_commit();
  for (int t = threadIdx.x; t < N; t += kThreads) s_sincos[t] = make_double2(sincos[2 * t], sincos[2 * t + 1]);
  for (int t = threadIdx.x; t < N - 1; t += kThreads) s_tw[t] = make_double2(tw_re[t], tw_im[t]);
  __pipeline_wait_prior(0);
  __syncthreads();                                               // tables (block-wide) and rows (warp-wide) are in

  const int r = lane / T, j = lane % T;                          // transform within the warp, thread within it
  const bool active = r < rows;
  const float* xin = my_io + r * S::IO_STRIDE;
  float* xout = my_io + r * S::IO_STRIDE;
  float2* pts = points + (warp * S::ROWS_PER_WARP + r) * S::PT_STRIDE;
  float re[8], im[8];

  // pre-twiddle into positions 8j .. 8j+7; position k holds element bit_reverse(k)
  if (active) {
    const int jr = __brev(j) >> (32 - (BITS - 3));
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int i = (bit_reverse(v, 3) << (BITS - 3)) | jr;
      const double2 cs = s_sincos[i];
      pre_twiddle(xin[2 * i], xin[HALF - 1 - 2 * i], cs.x, cs.y, re[v], im[v]);
    }
    run_pass<BITS, 0, 3>(re, im, j, first, s_tw);
    store_points<BITS, 0, 3>(pts, j, re, im);
  }
  __syncwarp();
  if (active) {
    load_points<BITS, 3, 3>(pts, j, re, im);
    run_pass<BITS, 3, 3>(re, im, j, first, s_tw);
  }
  if constexpr (BITS == 7) {
    if (active) store_points<BITS, 3, 3>(pts, j, re, im);
    __syncwarp();
    if (active) {
      load_points<BITS, 6, 1>(pts, j, re, im);
      run_pass<BITS, 6, 1>(re, im, j, first, s_tw);
    }
  }
  // post-twiddle from the last pass's positions (natural order) into the staged row;
  // every thread of the warp read its inputs before the first __syncwarp
  if (active) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int i = BITS == 7 ? position<BITS, 6, 1>(j, v) : position<BITS, 3, 3>(j, v);
      const double2 cs = s_sincos[i];
      post_twiddle(re[v], im[v], cs.x, cs.y, xout[HALF - 1 - 2 * i], xout[2 * i]);
    }
  }
  __syncwarp();

  for (int c = lane; c < rows * CHUNKS; c += 32) {
    const int r2 = c / CHUNKS, q = c % CHUNKS;
    *reinterpret_cast<float4*>(out + row0 * HALF + 4 * c) =
        *reinterpret_cast<const float4*>(my_io + r2 * S::IO_STRIDE + 4 * q);
  }
}

template <int SIZE>
void launch(const float* x, float* out, const double* sincos, const double* tw_re, const double* tw_im,
            const FirstTwiddles& first, int batch, cudaStream_t stream) {
  constexpr int TILE = Shape<SIZE>::TILE;
  imdct_mid_kernel<SIZE><<<(batch + TILE - 1) / TILE, kThreads, 0, stream>>>(x, out, sincos, tw_re, tw_im, first, batch);
}

}  // namespace

// sincos, tw_re, tw_im: the tables of carta1_tpu_torch.tables.imdct_tables(size)
// in device memory; host_*: the same tables in host memory (read during the call).
extern "C" int carta1_imdct_mid(const float* x, float* out, const double* sincos, const double* tw_re,
                                const double* tw_im, const double* host_sincos, const double* host_tw_re,
                                const double* host_tw_im, int batch, int size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (size == 64) {
    Tables64 tab;
    for (int i = 0; i < 32; ++i) tab.sincos[i] = host_sincos[i];
    for (int i = 0; i < 15; ++i) tab.tw_re[i] = host_tw_re[i], tab.tw_im[i] = host_tw_im[i];
    imdct64_kernel<<<(batch + kRows64 - 1) / kRows64, kRows64, 0, st>>>(x, out, tab, batch);
    return static_cast<int>(cudaGetLastError());
  }
  FirstTwiddles first;
  for (int i = 0; i < 7; ++i) first.re[i] = host_tw_re[i], first.im[i] = host_tw_im[i];
  switch (size) {
    case 256: launch<256>(x, out, sincos, tw_re, tw_im, first, batch, st); break;
    case 512: launch<512>(x, out, sincos, tw_re, tw_im, first, batch, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
