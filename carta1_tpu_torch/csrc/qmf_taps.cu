// K2: bit-exact QMF synthesis taps (qmf.js:88-101).
//
// Replaces the Pallas kernel carta1_tpu/ops/exact_qmf_pallas.py
// (_qmf_core_call, body _tap_body), which carries the f64 sums in f32
// error-free expansions.  Here each output is the gold engine's loop
// (carta1_tpu/gold/transforms.py qmf_synthesis_stream): an f64 sum over
// the 24 taps in tap order, each product and each sum rounded to nearest
// in f64, the total rounded once to f32.
//
//   s0[i] = sum_j EVEN[j] * work[2i + 2j],  s1[i] = sum_j ODD[j] * work[2i + 2j + 1]
//   out[2i] = s1[i],  out[2i + 1] = s0[i]
//
// work is [batch, 46 + 2s] f32 (each frame's merged stream behind its
// 46-sample halo), out is [batch, 2s] f32; one thread per (s0, s1) pair.
//
// Bound on this card: bytes.  A pair reads ~8 bytes of fresh input and
// writes 8, against 96 f64 ops; at 3.35 TB/s and 34 TFLOP/s the two
// bounds are within a factor of two, and the sequential tap order the
// reference fixes rules out any tree reduction.  Neighbouring threads
// read overlapping windows, which the L1 cache serves.
#include "exact.cuh"

namespace {

constexpr int kTaps = 24;
constexpr int kHalo = 46;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) qmf_taps_kernel(
    const float* __restrict__ work, float* __restrict__ out,
    const double* __restrict__ taps,   // [48]: EVEN[0..24) then ODD[0..24), f64 of the f32 window
    long long pairs, int s) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const long long b = idx / s;
  const int i = static_cast<int>(idx - b * s);
  const float* w = work + b * (kHalo + 2 * s) + 2 * i;
  double s0 = 0.0, s1 = 0.0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    s0 = __dadd_rn(s0, __dmul_rn(static_cast<double>(w[2 * j]), taps[j]));
    s1 = __dadd_rn(s1, __dmul_rn(static_cast<double>(w[2 * j + 1]), taps[kTaps + j]));
  }
  float* o = out + b * (2 * s) + 2 * i;
  o[0] = rn32(s1);
  o[1] = rn32(s0);
}

}  // namespace

extern "C" int carta1_qmf_taps(const float* work, float* out, const double* taps,
                               long long batch, int s, void* stream) {
  const long long pairs = batch * s;
  const long long grid = (pairs + kThreads - 1) / kThreads;
  qmf_taps_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      work, out, taps, pairs, s);
  return static_cast<int>(cudaGetLastError());
}
