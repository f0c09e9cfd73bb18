// Instruction rates that bound the exact kernels: unfused f64 adds and
// multiplies (by a register, by a kernel parameter), the f64 -> f32
// rounding and the f32 -> f64 widening, alone and mixed.
//
// Not a kernel of the decode path: carta1_tpu_torch/probe_rates.py runs it
// to say what the card gives K1 and K2 per rounding and per widening, and
// whether conversions and f64 arithmetic share a pipe (a mix that takes the
// sum of its parts' times does; one that takes the larger does not).
// Each thread carries 8 independent chains, so latency is hidden.
#include "exact.cuh"

namespace {

constexpr int kChains = 8;

struct Factors {
  double f[kChains];
};

// mode 0: dadd; 1: round then widen; 2: dadd and round+widen; 3: round only; 4: widen only;
// 5: dmul by a register; 6: dmul by a kernel parameter (a constant-bank operand)
template <int MODE>
__global__ void __launch_bounds__(256) probe_kernel(double* out, int iters, double seed,
                                                    const __grid_constant__ Factors factors) {
  double d[kChains];
  float f[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    d[i] = seed * (threadIdx.x + 1 + i);
    f[i] = static_cast<float>(d[i]);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (MODE == 0 || MODE == 2) d[i] = __dadd_rn(d[i], seed);
      if (MODE == 1 || MODE == 2) d[i] = static_cast<double>(rn32(d[i]));
      if (MODE == 3) {
        f[i] = rn32(d[i]);
        d[i] = __hiloint2double(__double2hiint(d[i]), __float_as_int(f[i]));
      }
      if (MODE == 5) d[i] = __dmul_rn(d[i], seed);
      if (MODE == 6) d[i] = __dmul_rn(d[i], factors.f[i]);
      if (MODE == 4) {
        d[i] = static_cast<double>(f[i]);
        f[i] = __int_as_float(__double2hiint(d[i]));
      }
    }
  }
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) sum += d[i] + f[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// out: blocks * 256 doubles.  Per thread and iteration a mode does 8 of each
// operation it names.
extern "C" int carta1_probe(double* out, int mode, int blocks, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Factors fac;
  for (int i = 0; i < kChains; ++i) fac.f[i] = 1.0 + 1e-9 * (i + 1);
  switch (mode) {
    case 0: probe_kernel<0><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    case 1: probe_kernel<1><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    case 2: probe_kernel<2><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    case 3: probe_kernel<3><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    case 4: probe_kernel<4><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    case 5: probe_kernel<5><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    case 6: probe_kernel<6><<<blocks, 256, 0, st>>>(out, iters, 1.0000001, fac); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
