// Shared by every kernel source of repro_torch: the error-string entry
// point that the Python loader calls when a launch returns an error, the
// NaN-propagating min / max, and the ray slab test.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
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

// min(a, b) with NaN propagation, as jnp.minimum / torch.minimum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// one float through the read-only cache (global memory) or plainly (shared)
struct LoadLdg {
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldg(p);
  }
};
struct LoadPlain {
  __device__ __forceinline__ float operator()(const float* p) const {
    return *p;
  }
};

// A ray as the slab test takes it: its origin, 1/d (IEEE division) and
// the returned bit mask of zero direction components (|d| < 1e-30)
template <int N>
__device__ __forceinline__ unsigned load_ray(const float* origin,
                                             const float* direction, int dim,
                                             float (&o)[N], float (&inv)[N]) {
  unsigned zero = 0;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      o[c] = origin[c];
      const float d = direction[c];
      const bool z = fabsf(d) < 1e-30f;
      zero |= static_cast<unsigned>(z) << c;
      inv[c] = 1.0f / (z ? 1.0f : d);
    }
  }
  return zero;
}

// geometry.ray_box against [lo, hi], each float read through `load`: true
// on a hit, with t = max(tmin, 0). A zero direction component's slab is
// (-inf, inf) when the origin lies in it, else empty. No products are
// summed, so there is no contraction question.
template <int N, class Load>
__device__ __forceinline__ bool ray_slab(const float (&o)[N],
                                         const float (&inv)[N], unsigned zero,
                                         const float* lo, const float* hi,
                                         int dim, Load load, float& t) {
  float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      const float l = load(lo + c), h = load(hi + c);
      float lo_d, hi_d;
      if ((zero >> c) & 1u) {
        const bool inside = o[c] >= l && o[c] <= h;
        lo_d = inside ? -INFINITY : INFINITY;
        hi_d = inside ? INFINITY : -INFINITY;
      } else {
        const float t0 = (l - o[c]) * inv[c];
        const float t1 = (h - o[c]) * inv[c];
        lo_d = min_nan(t0, t1);
        hi_d = max_nan(t0, t1);
      }
      tmin = max_nan(tmin, lo_d);
      tmax = min_nan(tmax, hi_d);
    }
  }
  t = max_nan(tmin, 0.0f);
  return tmax >= t;
}
