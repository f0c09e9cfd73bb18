// K4: the budgeted greedy sweep of the bit allocators.
//
// Replaces carta1_tpu/ops/bitalloc.py _sweep, a lax.scan over the candidate
// positions that XLA compiles into one program (the JAX package has no
// Pallas kernel here).  As eager PyTorch the same loop is about twelve
// small launches per position, 780 positions per frame batch, so the port
// runs it as one kernel.  Semantics, word for word those of
// gold/coding.py allocate_bits_sweep and of the scan's step:
//
//   remaining = budget; abandoned = {}; wl[0..51] = 0
//   for each candidate c of the frame, in the order given:
//     bfu = (c >> 13) & 63; cost = (c >> 1) & 0xFFF; valid = c & 1
//     if !valid or bfu in abandoned: continue
//     if cost > remaining: abandoned += bfu        (never revisited)
//     else: remaining -= cost; wl[bfu] += 1
//
// cands is [frames, ncand] int32, already in descending-priority order;
// out is [frames, 52] int32.  Integer only: no rounding question.
//
// Bound on this card: bytes (one 4-byte read per candidate, a handful of
// integer operations on it).  One thread owns one frame and walks its
// candidates in order, so what the walk costs is latency: a row-per-thread
// read of [frames, ncand] would be uncoalesced and every step would wait on
// device memory.  A block therefore takes kFrames frames and has two kinds
// of warps: the first two sweep (one thread per frame) the tile of kTile
// candidates that lies in shared memory, while the other six stage the next
// tile into a second buffer (each warp reads whole 128-byte row segments,
// several in flight); one barrier per tile swaps the buffers.  The
// abandoned set is a 64-bit register; the word-length counters, indexed by
// a loaded value, live in shared memory as cnt[bfu][frame] (no bank
// conflicts; rows of the tile are padded for the same reason) and leave
// through coalesced stores.
#include "exact.cuh"

namespace {

constexpr int kFrames = 64;     // frames per block = sweeping threads (warps 0 and 1)
constexpr int kThreads = 256;   // the other six warps stage the next tile meanwhile
constexpr int kSweepWarps = kFrames / 32;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // candidates staged per pass
constexpr int kBfuSlots = 64;   // the candidate's BFU field has 6 bits
constexpr int kBfus = 52;

// Warps FirstWarp .. kWarps-1 copy candidates c0 .. c0+kTile-1 of the block's
// rows into `tile`; the trip count is a constant, so every load of a warp
// is in flight before the first store.
template <int FirstWarp>
__device__ __forceinline__ void stage(int (*tile)[kTile + 1], const int* __restrict__ cands, long long f0,
                                      int rows, int ncand, int c0, int warp, int lane) {
  constexpr int kStagers = kWarps - FirstWarp;
  constexpr int kTrips = (kFrames + kStagers - 1) / kStagers;
  if (lane >= min(kTile, ncand - c0)) return;
  const int* src = cands + f0 * ncand + c0 + lane;
  int v[kTrips];
#pragma unroll
  for (int j = 0; j < kTrips; ++j) {
    const int r = warp - FirstWarp + j * kStagers;
    v[j] = r < rows ? src[static_cast<long long>(r) * ncand] : 0;
  }
#pragma unroll
  for (int j = 0; j < kTrips; ++j) {
    const int r = warp - FirstWarp + j * kStagers;
    if (r < kFrames) tile[r][lane] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads) alloc_sweep_kernel(
    const int* __restrict__ cands, int* __restrict__ out, long long frames, int ncand, int budget) {
  __shared__ int tile[2][kFrames][kTile + 1];
  __shared__ int cnt[kBfuSlots][kFrames];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long f0 = static_cast<long long>(blockIdx.x) * kFrames;
  const long long left = frames - f0;
  const int rows = left < kFrames ? static_cast<int>(left) : kFrames;

  if (t < kFrames) {
    for (int b = 0; b < kBfuSlots; ++b) cnt[b][t] = 0;
  }
  stage<0>(tile[0], cands, f0, rows, ncand, 0, warp, lane);
  __syncthreads();

  int remaining = budget;
  unsigned long long abandoned = 0ull;
  int cur = 0;
  for (int c0 = 0; c0 < ncand; c0 += kTile, cur ^= 1) {
    if (warp >= kSweepWarps) {
      if (c0 + kTile < ncand) stage<kSweepWarps>(tile[cur ^ 1], cands, f0, rows, ncand, c0 + kTile, warp, lane);
    } else if (t < rows) {
      const int n = min(kTile, ncand - c0);
      for (int i = 0; i < n; ++i) {
        const int c = tile[cur][t][i];
        const int bfu = (c >> 13) & (kBfuSlots - 1);
        const int cost = (c >> 1) & 0xFFF;
        const unsigned long long bit = 1ull << bfu;
        if ((c & 1) && !(abandoned & bit)) {
          if (cost > remaining) {
            abandoned |= bit;
          } else {
            remaining -= cost;
            cnt[bfu][t] += 1;
          }
        }
      }
    }
    __syncthreads();     // the next tile is staged, this one is consumed
  }
  const int total = rows * kBfus;
  for (int idx = t; idx < total; idx += kThreads) {
    out[f0 * kBfus + idx] = cnt[idx % kBfus][idx / kBfus];
  }
}

}  // namespace

extern "C" int carta1_alloc_sweep(const int* cands, int* out, long long frames, int ncand,
                                  int budget, void* stream) {
  const long long grid = (frames + kFrames - 1) / kFrames;
  alloc_sweep_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cands, out, frames, ncand, budget);
  return static_cast<int>(cudaGetLastError());
}
