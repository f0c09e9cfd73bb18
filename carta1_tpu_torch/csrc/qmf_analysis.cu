// K8: the exact encoder's QMF analysis taps (qmf.js:19-50).
//
// Replaces no Pallas kernel: the JAX package's exact encoder runs these taps
// on the host, in NumPy (carta1_tpu/gold/transforms.py qmf_analysis_stream),
// and the port ran them as two f64 PyTorch passes over the whole stream per
// tap (~100 launches a tree level).  Each output is gold's loop: an f64 sum
// from +0.0 over the 24 taps in tap order, each product and each sum rounded
// to nearest in f64, then low = f32(even + odd), high = f32(even - odd).
//
//   work = [delay (46) | signal]
//   even[i] = sum_j EVEN[j] * work[47 - 2j + 2i]
//   odd[i]  = sum_j ODD[j]  * work[46 - 2j + 2i]
//
// In sample pairs (work[2k], work[2k + 1]) output i reads pairs i .. i + 23,
// tap j the pair k = i + 23 - j: odd takes the pair's first sample, even
// its second.  signal is [batch, n] f32, delay [batch, 46] f32; low and high
// are [batch, n / 2] f32.  An odd n's last sample is read by no output.
//
// Bound on this card: operations.  A pair moves 16 bytes but needs 96 f64
// multiplies and adds that may not fuse (half the card's FMA rate), and 2
// more for the band split; f32 -> f64 widenings retire at a quarter of the
// add rate, on a pipe of their own.  The design is K2's (csrc/qmf_taps.cu):
//   * a block owns R rows x C output pairs; the tile's C + 23 sample pairs
//     (its 46-sample halo included) arrive in shared memory once, by
//     cp.async, coalesced along the row.  A tile that starts within 46
//     samples of the row's start takes those from `delay`, so no
//     [delay | signal] copy is made;
//   * a thread computes kPairs consecutive outputs: it walks its
//     kPairs + 23 sample pairs once, from the last down, widens each sample
//     once and feeds it to every output whose window holds it, so inside
//     each output the taps still run j = 0..23 in order;
//   * the taps are kernel parameters: after unrolling, each is a
//     constant-bank operand of its multiply and costs no load;
//   * the tile is padded by one sample pair per kPairs, so that the threads
//     of a half-warp, kPairs pairs apart, hit different banks;
//   * the two bands go back through the same tile (padded likewise) and
//     leave as coalesced stores.
// Rows are 4-byte aligned only (n may be odd), so the copies move one
// sample each; the bound is the arithmetic, not the copies.  Where two NaNs
// meet in a sum (an input NaN and inf - inf's), this add keeps the NaN that
// the plain version keeps on the CPU, which is the reference's; ATen's add
// on the card, an FMA of a + 1 * b, keeps the other.
#include "exact.cuh"

#include <cuda_pipeline_primitives.h>

namespace {

constexpr int kTaps = 24;
constexpr int kHalo = 46;
constexpr int kThreads = 128;
constexpr int kPairs = 8;      // output pairs per thread

struct Taps {
  double even[kTaps];
  double odd[kTaps];
};

// Float offset of sample pair k in a padded tile row.
__host__ __device__ constexpr int padded(int k) { return 2 * k + 2 * (k / kPairs); }

// Float offset of band value k in a padded half of a tile row.
__device__ constexpr int padded_out(int k) { return k + k / kPairs; }

// Row length in floats for `segs` threads per row; half of it is odd, so
// that threads on neighbouring rows also spread over the banks.
int row_floats(int segs) {
  const int len = padded(segs * kPairs + kTaps - 1);
  return (len / 2) % 2 ? len : len + 2;
}

__global__ void __launch_bounds__(kThreads) qmf_analysis_kernel(
    const float* __restrict__ signal, const float* __restrict__ delay, float* __restrict__ low,
    float* __restrict__ high, const __grid_constant__ Taps taps, long long batch, long long n, int segs,
    int tile_rows, int row_len, long long col_tiles) {
  extern __shared__ __align__(16) float tile[];
  const long long n_out = n / 2;
  const long long b0 = static_cast<long long>(blockIdx.x / col_tiles) * tile_rows;
  const long long c0 = (blockIdx.x % col_tiles) * static_cast<long long>(segs * kPairs);   // first output pair
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), batch - b0));
  const int cols = static_cast<int>(min(static_cast<long long>(segs * kPairs), n_out - c0));   // valid pairs
  const int span = 2 * (cols + kTaps - 1);                          // samples a tile row reads

  for (int r = 0; r < rows; ++r) {
    const float* drow = delay + (b0 + r) * kHalo;
    const float* srow = signal + (b0 + r) * n;
    float* dst = tile + r * row_len;
    for (int k = threadIdx.x; k < span; k += kThreads) {
      const long long w = 2 * c0 + k;                               // index into [delay | signal]
      const float* src = w < kHalo ? drow + w : srow + (w - kHalo);
      __pipeline_memcpy_async(dst + padded(k >> 1) + (k & 1), src, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int r = threadIdx.x / segs, seg = threadIdx.x - r * segs;
  const bool active = r < rows && seg * kPairs < cols;
  const float* mine = tile + r * row_len + padded(seg * kPairs);
  double even[kPairs], odd[kPairs];
  if (active) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) even[p] = odd[p] = 0.0;
#pragma unroll
    for (int m = kPairs + kTaps - 2; m >= 0; --m) {
      const float2 v = *reinterpret_cast<const float2*>(mine + padded(m));
      const double o = static_cast<double>(v.x), e = static_cast<double>(v.y);
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int j = kTaps - 1 + p - m;                            // tap index for output p
        if (j >= 0 && j < kTaps) {
          even[p] = __dadd_rn(even[p], __dmul_rn(e, taps.even[j]));
          odd[p] = __dadd_rn(odd[p], __dmul_rn(o, taps.odd[j]));
        }
      }
    }
  }
  __syncthreads();                                                  // every window has been read
  const int half = segs * kPairs + segs;                            // floats of a row's low band
  if (active) {
    float* out = tile + r * row_len + padded_out(seg * kPairs);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      out[p] = rn32(__dadd_rn(even[p], odd[p]));
      out[half + p] = rn32(__dsub_rn(even[p], odd[p]));
    }
  }
  __syncthreads();

  for (int r2 = 0; r2 < rows; ++r2) {
    const float* src = tile + r2 * row_len;
    const long long at = (b0 + r2) * n_out + c0;
    for (int k = threadIdx.x; k < cols; k += kThreads) {
      low[at + k] = src[padded_out(k)];
      high[at + k] = src[half + padded_out(k)];
    }
  }
}

}  // namespace

// taps: host pointer to 48 doubles, EVEN[0..24) then ODD[0..24), the f64
// values of the f32 window.  Nothing is launched for batch == 0 or n < 2.
extern "C" int carta1_qmf_analysis(const float* signal, const float* delay, float* low, float* high,
                                   const double* taps, long long batch, long long n, void* stream) {
  const long long n_out = n / 2;
  if (batch <= 0 || n_out <= 0) return 0;
  Taps t;
  for (int j = 0; j < kTaps; ++j) {
    t.even[j] = taps[j];
    t.odd[j] = taps[kTaps + j];
  }
  const long long runs = (n_out + kPairs - 1) / kPairs;           // threads a whole row would take
  const int segs = runs < kThreads ? static_cast<int>(runs) : kThreads;
  const int tile_rows = kThreads / segs;
  const int row_len = row_floats(segs);
  const long long col_tiles = (n_out + segs * kPairs - 1) / (segs * kPairs);
  const long long row_tiles = (batch + tile_rows - 1) / tile_rows;
  if (row_tiles * col_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile_rows) * row_len * sizeof(float);   // at most 36 KB
  qmf_analysis_kernel<<<static_cast<unsigned>(row_tiles * col_tiles), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(signal, delay, low, high, t, batch, n, segs, tile_rows,
                                                             row_len, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
