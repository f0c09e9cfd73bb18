// K2: bit-exact QMF synthesis taps (qmf.js:88-101).
//
// Replaces the Pallas kernel carta1_tpu/ops/exact_qmf_pallas.py
// (_qmf_core_call, body _tap_body), which carries the f64 sums in f32
// error-free expansions.  Here each output is the gold engine's loop
// (carta1_tpu/gold/transforms.py qmf_synthesis_stream): an f64 sum over
// the 24 taps in tap order from +0.0, each product and each sum rounded to
// nearest in f64, the total rounded once to f32.
//
//   s0[i] = sum_j EVEN[j] * work[2i + 2j],  s1[i] = sum_j ODD[j] * work[2i + 2j + 1]
//   out[2i] = s1[i],  out[2i + 1] = s0[i]
//
// work is [batch, 46 + 2s] f32 (each frame's merged stream behind its
// 46-sample halo), out is [batch, 2s] f32.
//
// Bound on this card: operations.  A pair moves ~17 bytes but needs 96
// f64 multiplies and adds that may not fuse, i.e. half the card's FMA
// rate.  f32 -> f64 widenings retire at a quarter of the f64 add rate, on
// a pipe of their own (carta1_tpu_torch/probe_rates.py): at 48 per pair
// they take longer than the sums, at 8 per pair they hide behind them.
// The design:
//   * a block owns R rows x C output pairs; the C + 23 sample pairs each
//     row needs arrive in shared memory once, by 8-byte cp.async (rows are
//     8-byte but not 16-byte aligned), coalesced along the row;
//   * a thread computes kPairs consecutive pairs: it walks its
//     kPairs + 23 sample pairs once, widens each sample once, and feeds it
//     to every output whose window holds it.  Outputs advance together, so
//     inside each output the taps still run j = 0..23 in order;
//   * the taps are kernel parameters: after unrolling, each is a
//     constant-bank operand of its multiply and costs no load;
//   * the tile is padded by one sample pair per kPairs, so that the
//     threads of a half-warp, kPairs pairs apart, hit different banks;
//   * results go back through the same tile and leave as coalesced
//     8-byte stores.
#include "exact.cuh"

#include <cuda_pipeline_primitives.h>

namespace {

constexpr int kTaps = 24;
constexpr int kHalo = 46;
constexpr int kThreads = 128;
constexpr int kPairs = 8;               // output pairs per thread
constexpr int kMaxSegs = 256 / kPairs;  // a column tile spans at most 256 pairs

struct Taps {
  double even[kTaps];
  double odd[kTaps];
};

// Float offset of sample pair k in a padded tile row.
__host__ __device__ constexpr int padded(int k) { return 2 * k + 2 * (k / kPairs); }

// Row length in floats for `segs` threads per row; half of it is odd, so
// that threads on neighbouring rows also spread over the banks.
int row_floats(int segs) {
  const int len = padded(segs * kPairs + kTaps - 1);
  return (len / 2) % 2 ? len : len + 2;
}

__global__ void __launch_bounds__(kThreads) qmf_taps_kernel(
    const float* __restrict__ work, float* __restrict__ out, const __grid_constant__ Taps taps,
    long long batch, int s, int segs, int tile_rows, int row_len) {
  extern __shared__ __align__(16) float tile[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int c0 = blockIdx.y * segs * kPairs;                       // first pair of the column tile
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), batch - b0));
  const int cols = min(segs * kPairs, s - c0);                     // valid pairs per row
  const long long width = kHalo + 2LL * s;

  for (int r = warp; r < rows; r += kWarps) {
    const float* src = work + (b0 + r) * width + 2 * c0;
    float* dst = tile + r * row_len;
    for (int k = lane; k < cols + kTaps - 1; k += 32)
      __pipeline_memcpy_async(dst + padded(k), src + 2 * k, 8);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int r = threadIdx.x / segs, seg = threadIdx.x - r * segs;
  const bool active = r < rows && seg * kPairs < cols;
  float* mine = tile + r * row_len + padded(seg * kPairs);         // also where the results go
  double s0[kPairs], s1[kPairs];
  if (active) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) s0[p] = s1[p] = 0.0;
#pragma unroll
    for (int m = 0; m < kPairs + kTaps - 1; ++m) {
      const float2 v = *reinterpret_cast<const float2*>(mine + padded(m));
      const double e = static_cast<double>(v.x), o = static_cast<double>(v.y);
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int j = m - p;                                        // tap index for output p
        if (j >= 0 && j < kTaps) {
          s0[p] = __dadd_rn(s0[p], __dmul_rn(e, taps.even[j]));
          s1[p] = __dadd_rn(s1[p], __dmul_rn(o, taps.odd[j]));
        }
      }
    }
  }
  __syncthreads();                                                  // every window has been read
  if (active) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
      *reinterpret_cast<float2*>(mine + 2 * p) = make_float2(rn32(s1[p]), rn32(s0[p]));
  }
  __syncthreads();

  for (int r2 = warp; r2 < rows; r2 += kWarps) {
    const float* src = tile + r2 * row_len;
    float* dst = out + (b0 + r2) * (2LL * s) + 2 * c0;
    for (int k = lane; k < cols; k += 32)
      *reinterpret_cast<float2*>(dst + 2 * k) = *reinterpret_cast<const float2*>(src + padded(k));
  }
}

__global__ void empty_kernel() {}

}  // namespace

// taps: host pointer to 48 doubles, EVEN[0..24) then ODD[0..24), the f64
// values of the f32 window.
extern "C" int carta1_qmf_taps(const float* work, float* out, const double* taps,
                               long long batch, int s, void* stream) {
  Taps t;
  for (int j = 0; j < kTaps; ++j) {
    t.even[j] = taps[j];
    t.odd[j] = taps[kTaps + j];
  }
  const int segs = min((s + kPairs - 1) / kPairs, kMaxSegs);
  const int tile_rows = kThreads / segs;
  const int row_len = row_floats(segs);
  const int col_tiles = (s + segs * kPairs - 1) / (segs * kPairs);
  const long long row_tiles = (batch + tile_rows - 1) / tile_rows;
  if (col_tiles > 65535 || row_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  const size_t smem = static_cast<size_t>(tile_rows) * row_len * sizeof(float);   // at most 36 KB
  qmf_taps_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      work, out, t, batch, s, segs, tile_rows, row_len);
  return static_cast<int>(cudaGetLastError());
}

// A kernel that returns at once: what one launch through this route costs.
extern "C" int carta1_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
