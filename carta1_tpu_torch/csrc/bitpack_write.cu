// K7: the sound-unit pack (serialization.js:41-110, bitstream.js:24).
//
// K7 replaces no Pallas kernel.  The JAX package's device pack,
// carta1_tpu/ops/bitpack.py pack_frames (:120), is XLA: a select and sum
// over [F, 1040, 74] windows, for n_bfu 52 only.  The port's plain version
// (ops/bitpack.py pack_frames_plain) lays every frame out for its own
// n_bfu with about 30 int64 passes over [N, 1145] fields and one
// scatter_add_; this kernel writes the same bytes in one launch.
//
// Semantics, those of the plain version, per frame:
//   header (16 bits at 0):  (2 - m0) << 14 | (2 - m1) << 12 | (3 - m2) << 10
//                           | searchsorted(BFU_AMOUNTS, n_bfu) << 5  (left side)
//   BFU i < n_bfu:          word length & 15 at 16 + 4i, scale factor & 63 at
//                           16 + 4 n_bfu + 6i, and the low w bits of each of
//                           its SPECS_PER_BFU[i] coefficients from
//                           16 + 10 n_bfu + (the bits of BFUs 0..i-1) on,
//                           w = WORD_LENGTH_BITS[wl] (0, then wl + 1)
//   BFU i >= n_bfu:         no bits
//   a bit at or past 1696:  dropped (the reference stops at the buffer end)
// MSB first.  The fields never share a bit, so ORs in any order give the
// unit.  n_bfu 0 packs to SILENT_UNIT.  Word lengths are taken in [0, 15],
// the 4-bit field's range (a larger one is read as 15 for its width: the
// plain version's bytes are unspecified there).
//
// Bound on this card: bytes.  A frame reads at most 4,592 bytes (its
// [52, 20] coefficients 4,160, scale factors and word lengths 208 each,
// modes 12, n_bfu 4) and writes 212; the integer work is a few operations
// a field.  The design: one warp per frame, kWarps frames a block, no
// 64-bit integer arithmetic but a frame's address.  Lane l takes BFUs 2l
// and 2l + 1 (l < 26): their word-length and scale-factor fields, and
// their coefficient bits (width x size), whose exclusive warp scan gives
// each BFU's first bit.
// Every field is ORed into the frame's 53 words (1,696 bits) in shared
// memory, a 54th word catching the tail of a field cut at the unit's end.
// The coefficients are read as 16-byte vectors, lane by lane over the
// frame's 260 (a BFU's 20 slots are five vectors), and only the vectors
// that hold a slot inside the BFU's size with a width above 0: padding
// slots and BFUs without bits cost no bytes.  The 53 words leave
// big-endian, coalesced: 212 bytes a row, 4-byte aligned.
#include "exact.cuh"

namespace {

constexpr int kFrameBits = 1696;
constexpr int kWords = kFrameBits / 32;        // 53
constexpr int kBfus = 52;
constexpr int kSlots = 20;
constexpr int kVecs = kBfus * kSlots / 4;      // 16-byte vectors of a frame's coefficients
constexpr int kHeaderBits = 16;
constexpr int kMaxBfu = 1024;                  // past 170 no coefficient, past 420 no scale factor fits
constexpr int kWarps = 8;                      // frames per block
constexpr unsigned kFull = 0xffffffffu;

__constant__ int kSpecs[kBfus] = {8, 8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8, 6, 6, 6, 6, 6, 6,
                                  6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 9, 9, 9, 9, 10, 10, 10, 10,
                                  12, 12, 12, 12, 12, 12, 12, 12, 20, 20, 20, 20, 20, 20, 20, 20};
__constant__ int kAmounts[8] = {20, 28, 32, 36, 40, 44, 48, 52};

// OR the field v (its low `width` bits, 1 <= width <= 16) into the words at
// bit `off` (>= 0); bits at or past the unit's end are dropped.
__device__ __forceinline__ void put(uint32_t* words, int off, int width, uint32_t v) {
  if (off >= kFrameBits) return;
  const int word = off >> 5;
  const int end = (off & 31) + width;
  if (end <= 32) {
    atomicOr(&words[word], v << (32 - end));
  } else {
    atomicOr(&words[word], v >> (end - 32));
    atomicOr(&words[word + 1], v << (64 - end));   // word + 1 == kWords: the dropped tail
  }
}

__device__ __forceinline__ int field_bits(int wl) { return wl > 0 ? min(wl, 15) + 1 : 0; }

__global__ void __launch_bounds__(kWarps * 32) pack_units_kernel(
    const int* __restrict__ n_bfu, const int* __restrict__ modes, const int* __restrict__ scale_factors,
    const int* __restrict__ word_lengths, const int4* __restrict__ quantized, uint32_t* __restrict__ out,
    long long frames) {
  __shared__ uint32_t words_all[kWarps][kWords + 1];
  __shared__ int first_bit_all[kWarps][kBfus];
  __shared__ int width_all[kWarps][kBfus];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long f = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (f >= frames) return;                     // a whole warp; no block barrier follows
  uint32_t* words = words_all[warp];
  int* first_bit = first_bit_all[warp];
  int* width = width_all[warp];

  words[lane] = 0u;
  if (lane + 32 <= kWords) words[lane + 32] = 0u;
  const int nb_in = n_bfu[f];
  const int nb = min(max(nb_in, 0), kMaxBfu);  // the same bits as the frame's own n_bfu
  __syncwarp();

  if (lane == 0) {
    int amount = 0;
#pragma unroll
    for (int a = 0; a < 8; ++a) amount += kAmounts[a] < nb_in;
    const uint32_t m0 = modes[3 * f], m1 = modes[3 * f + 1], m2 = modes[3 * f + 2];
    const uint32_t header = ((2u - m0) << 14) | ((2u - m1) << 12) | ((3u - m2) << 10) |
                            (static_cast<uint32_t>(amount) << 5);
    put(words, 0, kHeaderBits, header & 0xffffu);
  }

  int w[2] = {0, 0};
  int bits = 0;
  if (lane < kBfus / 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = 2 * lane + j;
      if (i < nb) {
        const int wl = word_lengths[f * kBfus + i];
        put(words, kHeaderBits + 4 * i, 4, static_cast<uint32_t>(wl) & 15u);
        put(words, kHeaderBits + 4 * nb + 6 * i, 6, static_cast<uint32_t>(scale_factors[f * kBfus + i]) & 63u);
        w[j] = field_bits(wl);
      }
    }
    bits = w[0] * kSpecs[2 * lane] + w[1] * kSpecs[2 * lane + 1];
  }
  int incl = bits;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane < kBfus / 2) {
    const int start = kHeaderBits + 10 * nb + incl - bits;
    first_bit[2 * lane] = start;
    width[2 * lane] = w[0];
    first_bit[2 * lane + 1] = start + w[0] * kSpecs[2 * lane];
    width[2 * lane + 1] = w[1];
  }
  __syncwarp();

  const int4* q = quantized + f * kVecs;
  for (int v = lane; v < kVecs; v += 32) {
    const int i = v / (kSlots / 4);
    const int k = 4 * (v - i * (kSlots / 4));  // the vector's first slot in its BFU
    const int wi = width[i];
    const int size = kSpecs[i];
    if (wi == 0 || k >= size) continue;
    const int4 x = __ldg(q + v);
    const uint32_t mask = (1u << wi) - 1u;
    const int off = first_bit[i] + k * wi;
    put(words, off, wi, static_cast<uint32_t>(x.x) & mask);
    if (k + 1 < size) put(words, off + wi, wi, static_cast<uint32_t>(x.y) & mask);
    if (k + 2 < size) put(words, off + 2 * wi, wi, static_cast<uint32_t>(x.z) & mask);
    if (k + 3 < size) put(words, off + 3 * wi, wi, static_cast<uint32_t>(x.w) & mask);
  }
  __syncwarp();

  uint32_t* row = out + f * kWords;
  row[lane] = __byte_perm(words[lane], 0u, 0x0123);
  if (lane + 32 < kWords) row[lane + 32] = __byte_perm(words[lane + 32], 0u, 0x0123);
}

}  // namespace

// n_bfu [frames], modes [frames, 3], scale_factors and word_lengths
// [frames, 52], quantized [frames, 52, 20] (16-byte aligned), all int32;
// out uint8 [frames, 212] (4-byte aligned).
extern "C" int carta1_pack_units(const int* n_bfu, const int* modes, const int* scale_factors,
                                 const int* word_lengths, const int* quantized, uint8_t* out,
                                 long long frames, void* stream) {
  const long long grid = (frames + kWarps - 1) / kWarps;
  pack_units_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n_bfu, modes, scale_factors, word_lengths, reinterpret_cast<const int4*>(quantized),
      reinterpret_cast<uint32_t*>(out), frames);
  return static_cast<int>(cudaGetLastError());
}
