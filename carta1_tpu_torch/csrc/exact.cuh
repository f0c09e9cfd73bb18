// Shared helpers of the exact decode kernels.
//
// The reference decoder computes in f64 and rounds to f32 at each store
// into a Float32Array.  Every f64 operation in these kernels is spelled
// as an explicit round-to-nearest intrinsic (__dmul_rn, __dadd_rn,
// __dsub_rn), which nvcc never contracts into an FMA; the build adds
// -fmad=false as a second guard.  A store rounds with __double2float_rn.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ float rn32(double v) { return __double2float_rn(v); }

// Each library built from one .cu exports its own copy (ctypes loads the
// libraries privately, so the names do not clash).
extern "C" const char* carta1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
