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
//   mode 1, magnitude spectrum of an N-point FFT (transient.js:17-35):
//     rows of N f32 samples (the real part; the imaginary part +0) ->
//     sqrt(re^2 + im^2) in f64 of the first N/2 bins, stored f32.
//
// Bound on this card: the f64 arithmetic and the f32 <-> f64 conversions
// of the per-stage stores (10 f64 operations and 4 conversion pairs per
// butterfly), as for K1; bytes are 8-12 per output value.  A simple
// design that is right: a block takes a tile of whole rows (16 KB of
// input for the MDCT, 8 KB for the spectrum), copies them coalesced into
// shared memory, and its 256 threads run each step over every point of
// the tile (pre-twiddle, each radix-2 stage, post-twiddle) with a block
// barrier between steps; the outputs leave coalesced from shared memory.
// Tables are copied to shared memory once per block.
#include "exact.cuh"

namespace {

constexpr int kThreads = 256;

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

template <int N>
struct Log2 {
  static constexpr int value = N == 16 ? 4 : N == 64 ? 6 : N == 128 ? 7 : 8;
};

template <int MODE, int N>
struct Shape {
  static constexpr int IN = MODE == 0 ? 4 * N : N;           // floats per input row
  static constexpr int OUT = MODE == 0 ? 2 * N : N / 2;      // floats per output row
  static constexpr int ROWS = (MODE == 0 ? 4096 : 2048) / IN;
  static constexpr int BITS = Log2<N>::value;
};

template <int MODE, int N>
__global__ void __launch_bounds__(kThreads) fftjs_kernel(
    const float* __restrict__ x, float* __restrict__ out, const double* __restrict__ sincos,
    const double* __restrict__ tw_re, const double* __restrict__ tw_im, long long batch) {
  using S = Shape<MODE, N>;
  constexpr int IN = S::IN, OUT = S::OUT, ROWS = S::ROWS, BITS = S::BITS;
  __shared__ float s_io[ROWS * IN];                 // the input rows, later the output rows
  __shared__ float s_re[ROWS * N], s_im[ROWS * N];  // the FFT's points, as the reference stores them
  __shared__ double2 s_tw[N];                       // stage q's twiddle k at 2^q - 1 + k
  __shared__ double2 s_sc[MODE == 0 ? N : 1];       // (cos, sin) pairs of the MDCT's sincos table

  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS), batch - row0));
  const int tid = threadIdx.x;
  for (int k = tid; k < N - 1; k += kThreads) s_tw[k] = make_double2(tw_re[k], tw_im[k]);
  if constexpr (MODE == 0)
    for (int k = tid; k < N; k += kThreads) s_sc[k] = make_double2(sincos[2 * k], sincos[2 * k + 1]);
  for (int c = tid; c < rows * IN; c += kThreads) s_io[c] = x[row0 * IN + c];
  __syncthreads();

  // the points, each at its bit-reversed position (fft.js's first step)
  for (int item = tid; item < rows * N; item += kThreads) {
    const int r = item / N, j = item % N;
    const int k = static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - BITS));
    const float* xi = s_io + r * IN;
    if constexpr (MODE == 0) {
      // pre-FFT butterfly (mdct.js:70-96), element i = 2j of two regions
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
      const double c = s_sc[j].x, s = s_sc[j].y;
      s_re[r * N + k] = rn32(__dadd_rn(__dmul_rn(a, c), __dmul_rn(b, s)));
      s_im[r * N + k] = rn32(__dsub_rn(__dmul_rn(b, c), __dmul_rn(a, s)));
    } else {
      s_re[r * N + k] = xi[j];
      s_im[r * N + k] = 0.0f;
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int q = 0; q < BITS; ++q) {
    const int h = 1 << q;
    for (int item = tid; item < rows * (N / 2); item += kThreads) {
      const int r = item / (N / 2), bi = item % (N / 2);
      const int k = bi & (h - 1), e = r * N + ((bi >> q) << (q + 1)) + k, o = e + h;
      const double2 w = s_tw[h - 1 + k];
      butterfly(s_re[e], s_im[e], s_re[o], s_im[o], w.x, w.y);
    }
    __syncthreads();
  }

  if constexpr (MODE == 0) {
    // post-twiddle (mdct.js:103-118)
    for (int item = tid; item < rows * N; item += kThreads) {
      const int r = item / N, i = item % N;
      const double rv = wide(s_re[r * N + i]), iv = wide(s_im[r * N + i]);
      const double c = s_sc[i].x, s = s_sc[i].y;
      float* o = s_io + r * OUT;
      o[2 * i] = rn32(__dsub_rn(__dmul_rn(-rv, c), __dmul_rn(iv, s)));
      o[OUT - 1 - 2 * i] = rn32(__dadd_rn(__dmul_rn(-rv, s), __dmul_rn(iv, c)));
    }
  } else {
    for (int item = tid; item < rows * OUT; item += kThreads) {
      const int r = item / OUT, k = item % OUT;
      const double rv = wide(s_re[r * N + k]), iv = wide(s_im[r * N + k]);
      s_io[r * OUT + k] = rn32(__dsqrt_rn(__dadd_rn(__dmul_rn(rv, rv), __dmul_rn(iv, iv))));
    }
  }
  __syncthreads();
  for (int c = tid; c < rows * OUT; c += kThreads) out[row0 * OUT + c] = s_io[c];
}

template <int MODE, int N>
void launch(const float* x, float* out, const double* sincos, const double* tw_re, const double* tw_im,
            long long batch, cudaStream_t stream) {
  constexpr int ROWS = Shape<MODE, N>::ROWS;
  const long long blocks = (batch + ROWS - 1) / ROWS;
  fftjs_kernel<MODE, N><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(x, out, sincos, tw_re, tw_im,
                                                                                    batch);
}

}  // namespace

// mode 0: the MDCT of size 4n (n = 16, 64, 128), x [batch, 4n] -> out [batch, 2n];
// mode 1: the magnitude spectrum of an n-point FFT (n = 128, 256), x [batch, n] -> out [batch, n/2].
// sincos (mode 0 only), tw_re, tw_im: tables.mdct_tables(4n) / fft_tables(n) on the card.
extern "C" int carta1_fftjs(const float* x, float* out, const double* sincos, const double* tw_re,
                            const double* tw_im, long long batch, int mode, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0 && n == 16) launch<0, 16>(x, out, sincos, tw_re, tw_im, batch, st);
  else if (mode == 0 && n == 64) launch<0, 64>(x, out, sincos, tw_re, tw_im, batch, st);
  else if (mode == 0 && n == 128) launch<0, 128>(x, out, sincos, tw_re, tw_im, batch, st);
  else if (mode == 1 && n == 128) launch<1, 128>(x, out, sincos, tw_re, tw_im, batch, st);
  else if (mode == 1 && n == 256) launch<1, 256>(x, out, sincos, tw_re, tw_im, batch, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
