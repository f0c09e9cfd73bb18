// K1: bit-exact IMDCT (mdct.js:139-211, fft.js:14-68), middle half only.
//
// Replaces the Pallas kernel carta1_tpu/ops/exact_fft_pallas.py
// (_imdct_core_call, body _core_body), which emulates f64 with f32
// error-free expansions because the TPU has no IEEE f64.  Hopper has f64,
// so this kernel mirrors the gold engine (carta1_tpu/gold/transforms.py
// imdct_js, gold/fftjs.py fft_js) operation for operation: each product
// and sum is one f64 op rounded to nearest, and each value the reference
// stores into a Float32Array is rounded to f32 at that point.
//
// Layout: x is [batch, size/2] f32 spectra, out is [batch, size/2] f32,
// the middle half [size/4, 3size/4) of the size-sample output -- the only
// part the decoder's overlap assembly reads.  One block transforms TILE
// rows with the complex working set (2 x TILE x size/4 f32) in shared
// memory: pre-twiddle into bit-reversed order, log2(size/4) radix-2
// stages with a __syncthreads between them, post-twiddle straight to
// global memory.
//
// Bound on this card: bytes (8 bytes per input coefficient in and out)
// against 21 to 24 f64 ops per coefficient -- at 3.35 TB/s and 34 TFLOP/s
// the transfer takes about three times as long as the arithmetic.  The
// design keeps the intermediate stages out of device memory; coalescing
// the scattered pre-twiddle reads is left to a later change.
#include "exact.cuh"

namespace {

constexpr int kThreads = 256;

template <int SIZE>
struct Shape {
  static constexpr int HALF = SIZE / 2;
  static constexpr int N = SIZE / 4;       // FFT points
  static constexpr int TILE = 2048 / N;    // transforms per block: 16 KB of shared memory
};

template <int SIZE>
__global__ void __launch_bounds__(kThreads) imdct_mid_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const double* __restrict__ sincos,   // [HALF] interleaved (cos, sin), mdct.js:20-38
    const int* __restrict__ perm,        // [N] bit reversal
    const double* __restrict__ tw_re,    // [N-1] stage twiddles from the f64 recurrence
    const double* __restrict__ tw_im, int batch) {
  constexpr int HALF = Shape<SIZE>::HALF, N = Shape<SIZE>::N, TILE = Shape<SIZE>::TILE;
  __shared__ float re[TILE * N];
  __shared__ float im[TILE * N];
  const int b0 = blockIdx.x * TILE;
  const int rows = min(TILE, batch - b0);   // uniform over the block

  // pre-twiddle (mdct.js:149-157): r = -x[2i], s = -x[half-1-2i];
  // gold evaluates re = s*sin + r*cos, im = s*cos - r*sin; the FFT's
  // bit reversal is applied by storing element i at position k.
  for (int e = threadIdx.x; e < rows * N; e += blockDim.x) {
    const int t = e / N, k = e - t * N;
    const int i = perm[k];
    const float* xr = x + static_cast<size_t>(b0 + t) * HALF;
    const double r = -static_cast<double>(xr[2 * i]);
    const double s = -static_cast<double>(xr[HALF - 1 - 2 * i]);
    const double c = sincos[2 * i], sn = sincos[2 * i + 1];
    re[e] = rn32(__dadd_rn(__dmul_rn(s, sn), __dmul_rn(r, c)));
    im[e] = rn32(__dsub_rn(__dmul_rn(s, c), __dmul_rn(r, sn)));
  }
  __syncthreads();

  // radix-2 DIT stages (fft.js:42-65): t = o * w, outputs RN32(e +- t)
  int off = 0;
  for (int stride = 2; stride <= N; stride <<= 1) {
    const int h = stride >> 1;
    for (int e = threadIdx.x; e < rows * (N / 2); e += blockDim.x) {
      const int t = e / (N / 2), j = e - t * (N / 2);
      const int g = j / h, k = j - g * h;
      const int ie = t * N + g * stride + k, io = ie + h;
      const double tr = tw_re[off + k], ti = tw_im[off + k];
      const double er = re[ie], ei = im[ie], orr = re[io], oi = im[io];
      const double t_r = __dsub_rn(__dmul_rn(orr, tr), __dmul_rn(oi, ti));
      const double t_i = __dadd_rn(__dmul_rn(orr, ti), __dmul_rn(oi, tr));
      re[ie] = rn32(__dadd_rn(er, t_r));
      re[io] = rn32(__dsub_rn(er, t_r));
      im[ie] = rn32(__dadd_rn(ei, t_i));
      im[io] = rn32(__dsub_rn(ei, t_i));
    }
    off += h;
    __syncthreads();
  }

  // post-twiddle (mdct.js:168-205): r1 = re*cos + im*sin, i1 = re*sin - im*cos.
  // Inside the middle half, r1[i] lands at half-1-2i and i1[i] at 2i.
  for (int e = threadIdx.x; e < rows * N; e += blockDim.x) {
    const int t = e / N, i = e - t * N;
    const double rv = re[e], iv = im[e];
    const double c = sincos[2 * i], sn = sincos[2 * i + 1];
    const double r1 = __dadd_rn(__dmul_rn(rv, c), __dmul_rn(iv, sn));
    const double i1 = __dsub_rn(__dmul_rn(rv, sn), __dmul_rn(iv, c));
    float* o = out + static_cast<size_t>(b0 + t) * HALF;
    o[2 * i] = rn32(i1);
    o[HALF - 1 - 2 * i] = rn32(r1);
  }
}

template <int SIZE>
void launch(const float* x, float* out, const double* sincos, const int* perm,
            const double* tw_re, const double* tw_im, int batch, cudaStream_t stream) {
  constexpr int TILE = Shape<SIZE>::TILE;
  const int grid = (batch + TILE - 1) / TILE;
  imdct_mid_kernel<SIZE><<<grid, kThreads, 0, stream>>>(x, out, sincos, perm, tw_re, tw_im, batch);
}

}  // namespace

extern "C" int carta1_imdct_mid(const float* x, float* out, const double* sincos, const int* perm,
                                const double* tw_re, const double* tw_im, int batch, int size,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 64: launch<64>(x, out, sincos, perm, tw_re, tw_im, batch, st); break;
    case 256: launch<256>(x, out, sincos, perm, tw_re, tw_im, batch, st); break;
    case 512: launch<512>(x, out, sincos, perm, tw_re, tw_im, batch, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
