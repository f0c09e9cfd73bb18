// K4: the bit allocators, each whole in one kernel.
//
// Replaces carta1_tpu/ops/bitalloc.py allocate_bits_rdo (:102) and
// allocate_bits (:187), whole: each is one XLA program (the error curve,
// the hull, a lax.sort of the 780 candidate steps per frame and the
// lax.scan of _sweep); the JAX package has no Pallas kernel here.  The
// kernel reads the coefficients and scale factors and writes the word
// lengths.  The error planes, the slopes and the sorted candidates never
// reach device memory.
//
// Semantics, those of the plain version (ops/bitalloc.py rdo_candidates or
// reference_candidates, then bitalloc_kernels.alloc_sweep_plain):
//   err[b][w]  = sum over the BFU's slots k, left to right in f32, of d*d,
//                d = v - q * step[sf][w],
//                q = clamp(trunc(x + (x >= 0 ? 0.5 : -0.5)), -R_w, R_w),
//                x = v * norm[sf][w], R_w = 2^w - 1 (tables.QUANT_RANGES)
//   e[b][w]    = err[b][w] * weight[sf]      (1.0 at bias 1)
//   s[b][i]    = (e[b][i] - e[b][i+1]) * per_bit[b][i],  i = 0..14
//   p[b][i]    = max(s[b][i..14])            NaN if any of them is NaN
//   valid      = sf > 0 and p > 0
// then every valid step, in descending order of p with ties to the lower
// (BFU, step), is paid for from the budget (1136 bits) if it fits, and
// abandons its BFU if it does not.  The reference allocator's p is
// 1023 - rank[sf][i] (ops/bitalloc.py _rank_table), valid where sf > 0.
// Every f32 operation is an explicit round-to-nearest intrinsic or an
// exact one (trunc, min, max, copysign); the build adds -fmad=false and no
// fast-math flag, so nothing is contracted or flushed to zero.  The one
// liberty: x's rounding offset is copysign(0.5, x).  It differs from the
// select only at x = -0 and x = NaN, where q becomes -0 instead of +0, or
// another NaN; d * d, and so the sums, are the same bits either way.
//
// Why a merge equals the stable sort: after the hull, p is non-increasing
// along a BFU's steps, so each BFU's valid steps form a list already in
// sort order, and the sorted sequence of all 780 is the 52-way merge of
// those lists that takes the largest head, ties to the lower BFU (the
// reference's max-heap, codec/coding/bitallocation.js).  A skipped
// candidate changes nothing, so a BFU that is abandoned or has no valid
// step left simply leaves the merge.  The reference's ranks are strictly
// increasing along a BFU's steps (held by a CPU test), so the same holds
// for it.  One more step: the budget left only falls, so a head that costs
// more than it now would be abandoned whenever its turn came; it is
// dropped at once, and every pop then pays.  A frame pops its accepted
// steps only (about 73 on music, at most 1136 / 4), not 780 candidates.
//
// Bound on this card: f32 operations.  A frame reads 4,160 bytes of
// coefficients and does 9 f32 operations per coefficient and word length
// (16 word lengths), about 18 per byte; the merge is a chain of warp
// reductions, hidden by the SM's other warps.  The design: one warp per
// frame.  The warp stages its frame's [52, 20] f32 into shared memory by
// 16-byte cp.async.  For the error curves lane l takes one or two BFUs
// whose slots sum to at most 20, in one loop over both (the warp runs 20
// slot steps, not the 26 or 29 of a BFU-per-lane split); each step updates
// the 16 word lengths' sums in registers, and a finished BFU's sums go to
// shared memory.  BFUs with sf 0 cost nothing: they are never valid.  Then
// lane l takes BFUs l and l + 32 (mask 0 from lane 20 on): it forms their
// slopes, hulls and valid masks, leaves the prices in shared memory over
// the sums, and merges.  Each pop is a __reduce_max_sync of the heads (a
// positive float's bits order as a uint32; 0 is "none"), a ballot for the
// lowest BFU that holds the maximum and a shuffle of its cost; the winning
// lane advances its head through the valid mask.  Outputs leave as
// coalesced stores.
//
// The reference allocator (alloc_reference_kernel) reads 208 bytes a frame
// and does no arithmetic to speak of; what bounds it is each frame's serial
// chain.  Its first design ran the merge above on rank prices, one pop per
// accepted step (66 a frame on music), each pop a reduction, two ballots, a
// shuffle and two dependent table loads: about 1 us a pop at 16,384 frames.
// A pop that is one reduction on the packed key below was no faster (the
// chain's latency sets the pace), so this design pops only after the
// sweep's first failure:
//   * the sweep pays for every candidate before the first one that does not
//     fit, so the warp bisects for the largest rank r whose lower ranks all
//     fit: spent(r) = sum over BFUs of specs[b] * bits[count[r][sf_b]] <=
//     budget, where count[r][s] is the number of steps of scale factor s
//     ranked below r (bitalloc_kernels.reference_tables, a [levels + 1, 64]
//     byte table read by row r, so a warp's loads fall in one 64-byte line),
//     one __reduce_add_sync per step, ceil(log2(levels + 1)) steps (8 at
//     bias 1, 10 at 0.7);
//   * the steps of rank r, one per BFU at most, are taken in BFU order by a
//     warp prefix sum: those whose running cost fits are paid, the first
//     that does not is abandoned;
//   * what is left of the budget is below that step's cost (at most 40
//     bits), so the rest is a short merge: each lane's head is one key
//     (1023 - rank) << 12 | (63 - b) << 6 | cost, 0 when it no longer fits,
//     and one __reduce_max_sync names the winner, its BFU and its cost (the
//     largest key is the lowest rank, ties to the lower BFU, exactly the
//     sweep's order).  About one pop a frame on music.
// testing.bisect_sweep_reference is this loop in NumPy, held to the plain
// version on the CPU.
#include "exact.cuh"

#include <cuda_pipeline_primitives.h>

namespace {

constexpr int kBfus = 52;
constexpr int kSlots = 20;               // coefficient slots per BFU
constexpr int kSteps = 15;               // word-length steps per BFU
constexpr int kWls = 16;                 // word lengths
constexpr int kWarps = 4;                // frames per block (bitalloc_kernels.BLOCK_FRAMES)
constexpr int kFrameFloats = kBfus * kSlots;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {     // torch.maximum: NaN if either is
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clamp_nan(float t, float r) {   // torch.clamp: NaN stays NaN
  float lo, hi;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(lo) : "f"(t), "f"(-r));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(hi) : "f"(lo), "f"(r));
  return hi;
}

// The error curves' BFUs of lane l: a first and (or -1) a second, slots at
// most 20 in all (SPECS_PER_BFU: 8 8 8 8 4 4 4 4 8 8 8 8, 6 x 12, 7 x 4,
// 9 x 4, 10 x 4, 12 x 8, 20 x 8).
__device__ __forceinline__ void lane_bfus(int lane, int& a, int& b) {
  if (lane < 8) {
    a = 44 + lane, b = -1;                                    // 20
  } else if (lane < 16) {
    a = 36 + lane - 8, b = lane < 12 ? lane - 8 : lane - 4;   // 12 + 8
  } else if (lane < 20) {
    a = 32 + lane - 16, b = 4 + lane - 16;                    // 10 + 4
  } else if (lane < 24) {
    a = 28 + lane - 20, b = 12 + lane - 20;                   // 9 + 6
  } else if (lane < 28) {
    a = 24 + lane - 24, b = 16 + lane - 24;                   // 7 + 6
  } else {
    a = 20 + lane - 28, b = -1;                               // 6
  }
}

__device__ __forceinline__ int table_row(int s) { return min(max(s, 0), 63); }

// The 16 running sums of one BFU's error curve.
struct Curve {
  float norm[kWls], step[kWls], err[kWls];

  __device__ __forceinline__ void start(const float* __restrict__ norm_tab, const float* __restrict__ step_tab,
                                        int s) {
    const float4* n4 = reinterpret_cast<const float4*>(norm_tab + table_row(s) * kWls);
    const float4* s4 = reinterpret_cast<const float4*>(step_tab + table_row(s) * kWls);
#pragma unroll
    for (int j = 0; j < kWls / 4; ++j) {
      const float4 n = __ldg(n4 + j), t = __ldg(s4 + j);
      norm[4 * j] = n.x, norm[4 * j + 1] = n.y, norm[4 * j + 2] = n.z, norm[4 * j + 3] = n.w;
      step[4 * j] = t.x, step[4 * j + 1] = t.y, step[4 * j + 2] = t.z, step[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int w = 0; w < kWls; ++w) err[w] = 0.0f;
  }

  __device__ __forceinline__ void add(float v) {
#pragma unroll
    for (int w = 0; w < kWls; ++w) {
      const float x = __fmul_rn(v, norm[w]);
      const float t = truncf(__fadd_rn(x, copysignf(0.5f, x)));
      const float q = clamp_nan(t, static_cast<float>((1 << w) - 1));
      const float d = __fsub_rn(v, __fmul_rn(q, step[w]));
      err[w] = __fadd_rn(err[w], __fmul_rn(d, d));
    }
  }

  __device__ __forceinline__ void store(float* sums) const {
#pragma unroll
    for (int w = 0; w < kWls; ++w) sums[w] = err[w];
  }
};

// One BFU of the merge: its valid steps left, the head's step, price and
// cost, and the steps accepted.
struct Head {
  int b, s, pos, cost, wl;
  unsigned mask, head;
};

__device__ __forceinline__ Head make_head(int b, int s, unsigned mask) {
  Head h;
  h.b = b, h.s = s, h.pos = 0, h.cost = 0, h.wl = 0, h.mask = mask, h.head = 0;
  return h;
}

// BFU b's prices over its error sums (sums[16], overwritten by prices[15])
// and its valid mask.
__device__ __forceinline__ unsigned hull(float* sums, int b, float weight, const float* __restrict__ per_bit) {
  float e[kWls];
#pragma unroll
  for (int w = 0; w < kWls; ++w) e[w] = __fmul_rn(sums[w], weight);
  unsigned valid = 0;
  float h = 0.0f;
#pragma unroll
  for (int i = kSteps - 1; i >= 0; --i) {
    const float s = __fmul_rn(__fsub_rn(e[i], e[i + 1]), __ldg(per_bit + b * kSteps + i));
    h = i == kSteps - 1 ? s : max_nan(s, h);
    if (h > 0.0f) valid |= 1u << i;
    sums[i] = h;
  }
  return valid;
}

// Move h to its first valid step at or after `from` (head 0 if none).
template <class Price>
__device__ __forceinline__ void seek(Head& h, const Price& price, const int* __restrict__ cost, int from) {
  const unsigned rest = h.mask & (~0u << from);
  if (rest) {
    h.pos = __ffs(rest) - 1;
    h.head = price(h);
    h.cost = __ldg(cost + h.b * kSteps + h.pos);
  } else {
    h.head = 0;
  }
}

// The merge-sweep of one frame; lane l owns BFUs lo = l and hi = l + 32.
// Every lane runs every pop.
template <class Price>
__device__ __forceinline__ void merge(Head& lo, Head& hi, const Price& price, const int* __restrict__ cost,
                                      int budget, int lane) {
  seek(lo, price, cost, 0);
  seek(hi, price, cost, 0);
  int remaining = budget;
  while (true) {
    if (lo.cost > remaining) lo.head = 0;                               // abandoned, whenever its turn
    if (hi.cost > remaining) hi.head = 0;
    const unsigned top = __reduce_max_sync(kFull, max(lo.head, hi.head));
    if (top == 0) break;
    const unsigned in_lo = __ballot_sync(kFull, lo.head == top);
    const bool is_lo = in_lo != 0;                                      // warp-uniform
    const unsigned who = is_lo ? in_lo : __ballot_sync(kFull, hi.head == top);
    const int w = __ffs(who) - 1;                                       // the lowest BFU wins a tie
    remaining -= __shfl_sync(kFull, is_lo ? lo.cost : hi.cost, w);      // it fits
    if (lane == w) {
      if (is_lo) {
        ++lo.wl;
        seek(lo, price, cost, lo.pos + 1);
      } else {
        ++hi.wl;
        seek(hi, price, cost, hi.pos + 1);
      }
    }
  }
}

__device__ __forceinline__ void store(int* __restrict__ out, long long f, const Head& lo, const Head& hi, int lane) {
  out[f * kBfus + lane] = lo.wl;
  if (lane + 32 < kBfus) out[f * kBfus + lane + 32] = hi.wl;
}

struct SharedPrice {
  const float* prio;
  __device__ __forceinline__ unsigned operator()(const Head& h) const {
    return __float_as_uint(prio[h.b * kWls + h.pos]);
  }
};

__global__ void __launch_bounds__(kWarps * 32) alloc_rdo_kernel(
    const float* __restrict__ bfu, const int* __restrict__ sf, const float* __restrict__ norm_tab,
    const float* __restrict__ step_tab, const float* __restrict__ weight, const float* __restrict__ per_bit,
    const int* __restrict__ cost, const int* __restrict__ specs, int* __restrict__ out, long long frames,
    int budget) {
  __shared__ __align__(16) float data_s[kWarps][kFrameFloats];
  __shared__ float sums_s[kWarps][kBfus * kWls];          // error sums, then prices
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long f = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (f >= frames) return;                       // no block-wide barrier follows

  // stage the frame: 260 coalesced 16-byte copies
  const float* src = bfu + f * kFrameFloats;
  float* data = data_s[warp];
  for (int k = lane; k < kFrameFloats / 4; k += 32) __pipeline_memcpy_async(data + 4 * k, src + 4 * k, 16);
  __pipeline_commit();
  const int* sfrow = sf + f * kBfus;
  int a, b;
  lane_bfus(lane, a, b);
  const int sa = sfrow[a], sb = b >= 0 ? sfrow[b] : 0;
  const int na = sa > 0 ? __ldg(specs + a) : 0, nb = b >= 0 && sb > 0 ? __ldg(specs + b) : 0;
  float* sums = sums_s[warp];
  __pipeline_wait_prior(0);
  __syncwarp();

  // the error curves of BFUs with sf > 0: one loop over the slots of both
  int cur = na ? a : b, n = na ? na : nb, left = na ? nb : 0;
  Curve curve;
  if (na + nb) curve.start(norm_tab, step_tab, na ? sa : sb);
  for (int j = 0, k = 0; j < na + nb; ++j) {
    curve.add(data[cur * kSlots + k]);
    if (++k == n) {
      curve.store(sums + cur * kWls);
      if (left) {
        cur = b, n = left, left = 0, k = 0;
        curve.start(norm_tab, step_tab, sb);
      }
    }
  }
  __syncwarp();

  // hulls of BFUs lane and lane + 32, then the merge
  const int slo = sfrow[lane], shi = lane + 32 < kBfus ? sfrow[lane + 32] : 0;
  const unsigned mlo = slo > 0 ? hull(sums + lane * kWls, lane, __ldg(weight + table_row(slo)), per_bit) : 0u;
  const unsigned mhi = shi > 0 ? hull(sums + (lane + 32) * kWls, lane + 32, __ldg(weight + table_row(shi)), per_bit)
                               : 0u;
  Head lo = make_head(lane, slo, mlo), hi = make_head(lane + 32, shi, mhi);
  merge(lo, hi, SharedPrice{sums}, cost, budget, lane);
  store(out, f, lo, hi, lane);
}

constexpr unsigned kTopRank = 1023;     // ranks are below 1024 (bitalloc_kernels.reference_tables)
constexpr int kCountRow = 64;           // bytes per rank in the count table, one per scale factor index

// The reference allocator's head key of BFU b (table row t, 0 for no
// candidate) at step n: 0 past the top step.
__device__ __forceinline__ unsigned ref_key(const int* __restrict__ rank, const int* bits, int t, int b, int spec,
                                            int n) {
  if (t == 0 || n >= kSteps) return 0u;
  const unsigned r = static_cast<unsigned>(__ldg(rank + t * kSteps + n));
  const unsigned c = static_cast<unsigned>(spec * (bits[n + 1] - bits[n]));
  return (kTopRank - r) << 12 | static_cast<unsigned>(63 - b) << 6 | c;
}

__global__ void __launch_bounds__(kWarps * 32) alloc_reference_kernel(
    const int* __restrict__ sf, const unsigned char* __restrict__ count, const int* __restrict__ rank,
    const int* __restrict__ specs, const int* __restrict__ bits_tab, int* __restrict__ out, long long frames,
    int budget, int levels) {
  __shared__ int bits[kWls];                     // bits of a BFU slot at each word length
  if (threadIdx.x < kWls) bits[threadIdx.x] = __ldg(bits_tab + threadIdx.x);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long f = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (f >= frames) return;
  const int* sfrow = sf + f * kBfus;
  const bool has_hi = lane + 32 < kBfus;
  const int s_lo = sfrow[lane], s_hi = has_hi ? sfrow[lane + 32] : 0;
  const int t_lo = s_lo > 0 ? min(s_lo, 63) : 0, t_hi = s_hi > 0 ? min(s_hi, 63) : 0;
  const int spec_lo = __ldg(specs + lane), spec_hi = has_hi ? __ldg(specs + lane + 32) : 0;

  // the largest rank r whose lower ranks all fit (r = 0 if none does)
  int lo = 0, hi = levels + 1, spent_lo = 0;
  while (hi - lo > 1) {                                                 // warp-uniform
    const int mid = (lo + hi) >> 1;
    const unsigned char* row = count + mid * kCountRow;
    const int spent = __reduce_add_sync(kFull, spec_lo * bits[__ldg(row + t_lo)] + spec_hi * bits[__ldg(row + t_hi)]);
    if (spent <= budget) {
      lo = mid, spent_lo = spent;
    } else {
      hi = mid;
    }
  }
  int n_lo = __ldg(count + lo * kCountRow + t_lo), n_hi = __ldg(count + lo * kCountRow + t_hi);
  int remaining = budget - spent_lo;

  // the steps of rank lo in BFU order (0..31 on the lanes' low BFUs, then
  // 32..51): paid while the running cost fits, the first over abandoned
  const int c_lo = t_lo && n_lo < kSteps && __ldg(rank + t_lo * kSteps + n_lo) == lo
                       ? spec_lo * (bits[n_lo + 1] - bits[n_lo]) : 0;
  const int c_hi = t_hi && n_hi < kSteps && __ldg(rank + t_hi * kSteps + n_hi) == lo
                       ? spec_hi * (bits[n_hi + 1] - bits[n_hi]) : 0;
  int p_lo = c_lo, p_hi = c_hi;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, p_lo, d), v = __shfl_up_sync(kFull, p_hi, d);
    if (lane >= d) p_lo += u, p_hi += v;
  }
  p_hi += __shfl_sync(kFull, p_lo, 31);
  const bool take_lo = c_lo > 0 && p_lo <= remaining, take_hi = c_hi > 0 && p_hi <= remaining;
  const unsigned over_lo = __ballot_sync(kFull, c_lo > 0 && !take_lo);
  const unsigned over_hi = __ballot_sync(kFull, c_hi > 0 && !take_hi);
  const int first = over_lo ? __ffs(over_lo) - 1 : over_hi ? 31 + __ffs(over_hi) : 64;
  remaining -= static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(max(take_lo ? p_lo : 0,
                                                                                   take_hi ? p_hi : 0))));
  n_lo += take_lo, n_hi += take_hi;

  // the rest of the sweep: the largest key that fits is paid for
  unsigned k_lo = lane == first ? 0u : ref_key(rank, bits, t_lo, lane, spec_lo, n_lo);
  unsigned k_hi = lane + 32 == first ? 0u : ref_key(rank, bits, t_hi, lane + 32, spec_hi, n_hi);
  while (true) {
    const unsigned fit_lo = static_cast<int>(k_lo & 63u) <= remaining ? k_lo : 0u;
    const unsigned fit_hi = static_cast<int>(k_hi & 63u) <= remaining ? k_hi : 0u;
    const unsigned top = __reduce_max_sync(kFull, max(fit_lo, fit_hi));
    if (top == 0) break;
    remaining -= static_cast<int>(top & 63u);
    const int w = 63 - static_cast<int>((top >> 6) & 63u);
    if (w == lane) {
      k_lo = ref_key(rank, bits, t_lo, lane, spec_lo, ++n_lo);
    } else if (w == lane + 32) {
      k_hi = ref_key(rank, bits, t_hi, lane + 32, spec_hi, ++n_hi);
    }
  }
  out[f * kBfus + lane] = n_lo;
  if (has_hi) out[f * kBfus + lane + 32] = n_hi;
}

unsigned grid_for(long long frames) { return static_cast<unsigned>((frames + kWarps - 1) / kWarps); }

}  // namespace

extern "C" int carta1_alloc_rdo(const float* bfu, const int* sf, const float* norm, const float* step,
                                const float* weight, const float* per_bit, const int* cost, const int* specs,
                                int* out, long long frames, int budget, void* stream) {
  alloc_rdo_kernel<<<grid_for(frames), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      bfu, sf, norm, step, weight, per_bit, cost, specs, out, frames, budget);
  return static_cast<int>(cudaGetLastError());
}

// sf int32 [frames, 52]; count uint8 [levels + 1, 64], rank int32 [64, 15], specs int32 [52] and bits
// int32 [16] (ops/bitalloc_kernels.py reference_tables); out int32 [frames, 52].
extern "C" int carta1_alloc_reference(const int* sf, const unsigned char* count, const int* rank, const int* specs,
                                      const int* bits, int* out, long long frames, int budget, int levels,
                                      void* stream) {
  if (levels < 0 || levels > static_cast<int>(kTopRank) + 1) return static_cast<int>(cudaErrorInvalidValue);
  alloc_reference_kernel<<<grid_for(frames), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      sf, count, rank, specs, bits, out, frames, budget, levels);
  return static_cast<int>(cudaGetLastError());
}
