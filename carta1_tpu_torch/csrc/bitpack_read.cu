// K3: sound-unit field read (serialization.js:111-176, bitstream.js:55).
//
// Replaces the Pallas kernel carta1_tpu/ops/bitpack_pallas.py
// (window_reduce_pallas, body _demux_kernel), a compare/select reduction
// over a restricted anchor range that stands in for a gather on the TPU.
// On this card the read is a plain gather, and the shift and mask of
// carta1_tpu/ops/bitpack.py _read_fields are applied in the same thread:
//
//   h = off >> 4, r = off & 15
//   win = win32[f, h] if j_lo <= h < j_hi else 0
//   eff = clamp(1696 - off, 0, width)     (a field cut by the unit end keeps
//                                          only the bits it read, un-shifted)
//   out = (win >> (32 - r - eff)) & ((1 << eff) - 1)
//
// win32 is [frames, 128] uint32, (half[j] << 16) | half[j+1] over a unit's
// big-endian halfwords; offsets, widths and out are [frames, m] int32.
//
// Bound on this card: bytes (16 bytes per field for 3 integer ops); the
// window row of a frame is 512 bytes and stays in L1 across its fields.
#include "exact.cuh"

namespace {

constexpr int kFrameBits = 1696;
constexpr int kAnchors = 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) read_fields_kernel(
    const uint32_t* __restrict__ win32, const int* __restrict__ offsets,
    const int* __restrict__ widths, int* __restrict__ out, long long total, int m,
    int j_lo, int j_hi) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long f = idx / m;
  const int off = offsets[idx];
  const int h = off >> 4;
  const uint32_t win = (h >= j_lo && h < j_hi) ? win32[f * kAnchors + h] : 0u;
  const int r = off & 15;
  const int eff = max(0, min(kFrameBits - off, widths[idx]));
  uint32_t v = 0u;
  if (eff > 0) v = (win >> (32 - r - eff)) & ((1u << eff) - 1u);
  out[idx] = static_cast<int>(v);
}

}  // namespace

extern "C" int carta1_read_fields(const uint32_t* win32, const int* offsets, const int* widths,
                                  int* out, long long frames, int m, int j_lo, int j_hi,
                                  void* stream) {
  const long long total = frames * m;
  const long long grid = (total + kThreads - 1) / kThreads;
  read_fields_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      win32, offsets, widths, out, total, m, j_lo, j_hi);
  return static_cast<int>(cudaGetLastError());
}
