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
//     word length (or where the next step would add no bit).
// Priorities are read from a table made on the host by the reference's
// own f64 operations (tables.heap_priority_table); the kernel computes
// none, it only compares them, so no device arithmetic decides an order.
// Scale factor indices outside 0..63 are clamped before the table read
// (the plain version takes only 0..63).  The slot counts and word-length
// bits come from the host's constants with each launch.
//
// Bound on this card: neither bytes (208 bytes in and out per frame) nor
// operations, but the heap's serial chain: about 73 accepted steps per
// frame of music, at most 1136 / 4, each a sift of up to 5 levels of
// dependent shared-memory loads and compares.  The design keeps that
// chain short: one thread per frame, the heap (priority, BFU) and the word
// lengths in shared memory, entry j of thread t at j * kThreads + t so
// that a warp's threads touch 32 different banks; the priority table and
// the slot counts are copied to shared memory once per block.  The
// frames of a warp take different numbers of steps; the warp runs as long
// as its longest frame.
#include "exact.cuh"

namespace {

constexpr int kThreads = 64;        // frames per block (ops/heap_kernels.py BLOCK_FRAMES)
constexpr int kBfus = 52;
constexpr int kTopWl = 15;          // MAX_WORD_LENGTH_INDEX

struct Steps {
  int specs[kBfus];                 // SPECS_PER_BFU: slots per BFU
  int bits[kTopWl + 1];             // WORD_LENGTH_BITS
};

struct Heap {
  double* pri;                      // this thread's entries, stride kThreads
  unsigned char* bfu;
  __device__ double& p(int j) const { return pri[j * kThreads]; }
  __device__ unsigned char& b(int j) const { return bfu[j * kThreads]; }

  __device__ void sift_down(int start, int n) const {
    int i = start;
    const unsigned char iv = b(i);
    const double pv = p(i);
    while (true) {
      const int l = 2 * i + 1, r = l + 1;
      int mi = i;
      double mp = pv;
      if (l < n && p(l) > mp) mi = l, mp = p(l);
      if (r < n && p(r) > mp) mi = r;
      if (mi == i) break;
      b(i) = b(mi);
      p(i) = p(mi);
      i = mi;
    }
    b(i) = iv;
    p(i) = pv;
  }

  __device__ void pop_root(int& n) const {
    --n;
    b(0) = b(n);
    p(0) = p(n);
    if (n > 0) sift_down(0, n);
  }
};

__global__ void __launch_bounds__(kThreads) alloc_heap_kernel(
    const int* __restrict__ sf_idx, const double* __restrict__ priority, int* __restrict__ out,
    const __grid_constant__ Steps steps, long long frames, int budget) {
  __shared__ double s_priority[64 * kTopWl];
  __shared__ double h_pri[kBfus * kThreads];
  __shared__ unsigned char h_bfu[kBfus * kThreads];
  __shared__ unsigned char s_wl[kBfus * kThreads];
  __shared__ unsigned char s_sf[kBfus * kThreads];
  for (int k = threadIdx.x; k < 64 * kTopWl; k += kThreads) s_priority[k] = priority[k];
  __syncthreads();

  const long long f = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= frames) return;
  const int t = threadIdx.x;
  const Heap heap{h_pri + t, h_bfu + t};
  unsigned char* wl = s_wl + t;
  unsigned char* sf = s_sf + t;

  int n = 0;
  const int* row = sf_idx + f * kBfus;
  for (int b = 0; b < kBfus; ++b) {
    const int s = min(max(row[b], 0), 63);
    sf[b * kThreads] = static_cast<unsigned char>(s);
    wl[b * kThreads] = 0;
    if (steps.specs[b] > 0 && s > 0) {
      heap.b(n) = static_cast<unsigned char>(b);
      heap.p(n) = s_priority[s * kTopWl];
      ++n;
    }
  }
  for (int i = n / 2 - 1; i >= 0; --i) heap.sift_down(i, n);

  int remaining = budget;
  while (remaining > 0 && n > 0) {
    const int b = heap.b(0);
    const int cur = wl[b * kThreads], nxt = cur + 1;
    const int cost = (steps.bits[nxt] - steps.bits[cur]) * steps.specs[b];
    if (cost > remaining || cost <= 0) {
      heap.pop_root(n);
      continue;
    }
    remaining -= cost;
    wl[b * kThreads] = static_cast<unsigned char>(nxt);
    if (nxt < kTopWl && steps.bits[nxt + 1] - steps.bits[nxt] > 0) {
      heap.p(0) = s_priority[sf[b * kThreads] * kTopWl + nxt];
      heap.sift_down(0, n);
    } else {
      heap.pop_root(n);
    }
  }

  int* o = out + f * kBfus;
  for (int b = 0; b < kBfus; ++b) o[b] = wl[b * kThreads];
}

}  // namespace

// sf_idx int32 [frames, 52] and priority f64 [64, 15] (tables.heap_priority_table)
// on the card; host_specs int32 [52] (SPECS_PER_BFU) and host_bits int32 [16]
// (WORD_LENGTH_BITS) in host memory, read during the call.
extern "C" int carta1_alloc_heap(const int* sf_idx, const double* priority, int* out, const int* host_specs,
                                 const int* host_bits, long long frames, int budget, void* stream) {
  Steps steps;
  for (int b = 0; b < kBfus; ++b) steps.specs[b] = host_specs[b];
  for (int w = 0; w <= kTopWl; ++w) steps.bits[w] = host_bits[w];
  const long long blocks = (frames + kThreads - 1) / kThreads;
  alloc_heap_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sf_idx, priority, out, steps, frames, budget);
  return static_cast<int>(cudaGetLastError());
}
