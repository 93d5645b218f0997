// Shared by every kernel source of repro_torch: the error-string entry
// point that the Python loader calls when a launch returns an error.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// max(a, b) with NaN propagation, as jnp.maximum / torch.maximum
// (fmaxf would drop a NaN operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
