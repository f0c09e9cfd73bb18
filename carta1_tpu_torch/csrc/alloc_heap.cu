// K5: the reference's max-heap bit allocator, one frame per thread.
//
// Replaces carta1_tpu/gold/coding.py allocate_bits_frame (:70), run per
// frame by allocate_bits (:154): the greedy allocation of
// codec/coding/bitallocation.js:44-164 with the reference's own max-heap,
// its ties broken in heap-array order.  The JAX package runs it in NumPy
// on the host, one frame at a time; it has no Pallas kernel.
//
// Semantics (those of the plain version, ops/heap_kernels.py):
//   * BFUs with sf > 0 enter the heap in BFU order (every BFU has slots),
//     each with the priority of its step 0 -> 1; then sift_down(i) for
//     i = n/2 - 1 down to 0;
//   * sift_down compares the left child first and moves an entry only for
//     a strictly larger priority;
//   * while bits remain and the heap is not empty: the root's next step
//     costs (bits[w + 1] - bits[w]) * slots; if that is more than what
//     remains (or not positive) the root is popped (last entry to the
//     root, then sift_down(0)); otherwise it is paid for, the word length
//     steps, and the root is re-priced and sifted, or popped at the top
//     word length (or where the next step would add no bit).  Once fewer
//     bits remain than the cheapest step of any BFU, the pops that would
//     follow change no word length: the loop stops there.
// Priorities are never computed or compared as floats here: the host
// ranks the reference's f64 priority table (tables.heap_priority_table,
// made by the reference's own operations) into tables.heap_rank_table,
// where equal priorities share a rank and a larger priority has a larger
// rank, so every strict comparison of the heap gives the reference's
// answer.  Scale factor indices outside 0..63 are clamped before the table
// read (the plain version takes only 0..63).
//
// Bound on this card: neither bytes (208 bytes in and out per frame) nor
// operations, but each frame's serial chain: its accepted steps and pops,
// each a sift of up to 5 levels of dependent shared-memory loads and
// compares (chip_smoke.py counts them on the main path's input).  16,384
// frames make one warp per scheduler, so nothing hides a latency and the
// chain's length per step is the time; a warp runs as long as its longest
// frame.  The design shortens each link of the chain:
//   * a heap entry is one 16-bit key, (rank << 6) | BFU, compared by its
//     rank: one shared load per child, both children loaded before the
//     compare, 32 threads on 16 banks with no conflict (entry j of thread
//     t at j * kThreads + t);
//   * the root key stays in a register between steps; a frame's scale
//     factor and word length per BFU are one 16-bit word, so a step reads
//     one word, its cost from a shared [52, 16] table and its new rank from
//     a shared [64, 16] table; nothing is read from kernel parameters with
//     a per-thread index;
//   * blocks are one warp; the block's rows come in and leave coalesced
//     (16-byte loads in, 4-byte stores out) through a shared staging
//     area whose per-frame stride of 53 words keeps the threads' own rows
//     on different banks.
#include "exact.cuh"

namespace {

constexpr int kThreads = 32;        // frames per block (ops/heap_kernels.py BLOCK_FRAMES)
constexpr int kBfus = 52;
constexpr int kCols = 16;           // word lengths 0..15 per table row
constexpr int kRowStride = kBfus + 1;

struct Heap {
  unsigned short* key;              // this thread's entries, stride kThreads; the slot past the last holds 0

  // Sift the entry `k` down from position i of a heap of n entries; returns
  // the key that ends at position i.  A child wins only with a strictly
  // larger rank: key > (other | 63).  The slot past the last entry holds
  // key 0, so a missing right child never wins and both children load
  // unconditionally, before the compare.
  __device__ __forceinline__ unsigned sift_down(int i, int n, unsigned k) const {
    const unsigned kth = k | 63u;
    const int start = i;
    unsigned top = k;
    for (int l = 2 * i + 1; l < n; l = 2 * i + 1) {
      const unsigned kl = key[l * kThreads], kr = key[(l + 1) * kThreads];
      const bool right = kr > (kl | 63u);
      const unsigned kc = right ? kr : kl;
      if (kc <= kth) break;
      key[i * kThreads] = static_cast<unsigned short>(kc);
      if (i == start) top = kc;
      i = l + right;
    }
    key[i * kThreads] = static_cast<unsigned short>(k);
    return top;
  }
};

__global__ void __launch_bounds__(kThreads) alloc_heap_kernel(
    const int* __restrict__ sf_idx, const unsigned short* __restrict__ rank, const short* __restrict__ cost,
    int* __restrict__ out, long long frames, int budget, int min_cost) {
  __shared__ __align__(16) unsigned short s_rank[64 * kCols];   // rank of the step w -> w + 1 at scale factor s
  __shared__ __align__(16) short s_cost[kBfus * kCols];         // bits of BFU b's step w -> w + 1; 0 at the top
  __shared__ int s_rows[kThreads * kRowStride];                  // the block's rows in, its word lengths out
  __shared__ unsigned short s_key[(kBfus + 1) * kThreads];       // the heaps
  __shared__ unsigned short s_sw[kBfus * kThreads];              // (scale factor << 4) | word length per BFU

  const long long f0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nf = static_cast<int>(min(static_cast<long long>(kThreads), frames - f0));
  const int t = threadIdx.x;
  for (int k = t; k < 64 * kCols / 8; k += kThreads)
    reinterpret_cast<uint4*>(s_rank)[k] = reinterpret_cast<const uint4*>(rank)[k];
  for (int k = t; k < kBfus * kCols / 8; k += kThreads)
    reinterpret_cast<uint4*>(s_cost)[k] = reinterpret_cast<const uint4*>(cost)[k];
  const int4* rows_in = reinterpret_cast<const int4*>(sf_idx + f0 * kBfus);
  for (int k = t; k < nf * kBfus / 4; k += kThreads) {
    const int4 v = rows_in[k];
    const int e = 4 * k, r = e / kBfus, b = e % kBfus;     // 52 = 13 * 4: a piece never spans two rows
    int* dst = s_rows + r * kRowStride + b;
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
  __syncthreads();

  if (t < nf) {
    const Heap heap{s_key + t};
    unsigned short* sw = s_sw + t;
    int* row = s_rows + t * kRowStride;
    int n = 0;
    for (int b = 0; b < kBfus; ++b) {
      const int s = min(max(row[b], 0), 63);
      sw[b * kThreads] = static_cast<unsigned short>(s << 4);
      if (s > 0 && s_cost[b * kCols] > 0) {                  // step 0 -> 1 costs bits: the BFU has slots
        heap.key[n * kThreads] = static_cast<unsigned short>((s_rank[s * kCols] << 6) | b);
        ++n;
      }
    }
    heap.key[n * kThreads] = 0;
    for (int i = n / 2 - 1; i >= 0; --i) heap.sift_down(i, n, heap.key[i * kThreads]);

    // One sift per step, whether it re-prices the root or pops it, so the
    // threads of a warp share one sift loop.  Once fewer bits remain than
    // the cheapest step of any BFU (min_cost), every further root would be
    // popped without a step: the loop stops there with the same word lengths.
    unsigned root = heap.key[0];
    int remaining = budget;
    while (remaining >= min_cost && n > 0) {
      const int b = root & 63;
      const unsigned v = sw[b * kThreads];
      const int w = v & 15;
      const int c = s_cost[b * kCols + w], c_next = s_cost[b * kCols + w + 1];
      const unsigned k_next = (s_rank[(v >> 4) * kCols + w + 1] << 6) | b;
      bool pop = c > remaining || c <= 0;                    // popped with no step
      if (!pop) {
        remaining -= c;
        sw[b * kThreads] = static_cast<unsigned short>(v + 1);
        pop = c_next <= 0;                                   // the top word length, or a step that adds no bit
      }
      unsigned k = k_next;
      if (pop) {                                             // the last entry to the root
        k = heap.key[--n * kThreads];
        heap.key[n * kThreads] = 0;
      }
      if (n > 0) root = heap.sift_down(0, n, k);
    }
    for (int b = 0; b < kBfus; ++b) row[b] = sw[b * kThreads] & 15;
  }
  __syncthreads();

  for (int k = t; k < nf * kBfus; k += kThreads) out[f0 * kBfus + k] = s_rows[(k / kBfus) * kRowStride + k % kBfus];
}

}  // namespace

// sf_idx int32 [frames, 52] (16-byte aligned), rank uint16 [64, 16] (tables.heap_rank_table,
// a zero column appended) and cost int16 [52, 16] (ops/heap_kernels.py, the bits of each BFU's
// step w -> w + 1, 0 at w = 15) on the card; out int32 [frames, 52]; min_cost the least positive
// entry of cost.
extern "C" int carta1_alloc_heap(const int* sf_idx, const unsigned short* rank, const short* cost, int* out,
                                 long long frames, int budget, int min_cost, void* stream) {
  if (min_cost < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (frames + kThreads - 1) / kThreads;
  alloc_heap_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sf_idx, rank, cost, out, frames, budget, min_cost);
  return static_cast<int>(cudaGetLastError());
}
