// The ray leaf tests of predicates.leaf_ray_hit in the "walk" float order
// (the order XLA:CPU gives the reference's jitted walks and its callback
// kernel), shared by the callback kernel's ray walks (bvh_callback.cu) and
// the ray kNN walk (ray_knn.cu), so that both compile the same float
// order; and the 16-byte value records of a tree's leaves that the 3-D
// instances read (kernels.bvh_traverse.pack_values).
//
// Every library is built with --fmad=false: the only fused multiply-adds
// are the explicit __fmaf_rn below, and division and sqrtf are IEEE.
#pragma once

#include <cmath>

#include "common.cuh"

// A ray as the slab test takes it: origin and 1/d (IEEE division) in
// registers with the bit mask of zero direction components (|d| < 1e-30),
// as load_ray gives them; the direction stays in global memory, read at a
// leaf that needs it (any dim up to N)
template <int N>
struct RayReg {
  float o[N], inv[N];
  unsigned zero;
  const float* dir;

  __device__ __forceinline__ void load(const float* origin,
                                       const float* direction, int dim) {
    zero = load_ray(origin, direction, dim, o, inv);
    dir = direction;
  }
};

// a 3-D ray, its direction in registers too
struct Ray3 : RayReg<3> {
  float d[3];

  __device__ __forceinline__ void load(const float* origin,
                                       const float* direction, int) {
    RayReg<3>::load(origin, direction, 3);
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = __ldg(direction + c);
  }
};

// geometry.ray_sphere, "walk" order: d.d and (o-c).d fused, |o-c|^2
// unfused, c = fma(-r, r, |o-c|^2), disc = fma(b, b, -(d.d c)). True on a
// hit, with its t (the nearer root when it is >= 0, else the farther).
// dir(c) and cen(c) give the c-th component of the direction and of the
// centre (from registers, or read where they are needed in any dim).
template <int N, class Dir, class Cen>
__device__ __forceinline__ bool ray_sphere(const float (&o)[N], Dir dir,
                                           Cen cen, float r, int dim,
                                           float& t) {
  float d2 = 0.0f, b = 0.0f, s = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      const float dc = dir(c);
      const float oc = o[c] - cen(c);
      d2 = __fmaf_rn(dc, dc, d2);
      b = __fmaf_rn(oc, dc, b);
      s = s + oc * oc;
    }
  }
  const float cc = __fmaf_rn(-r, r, s);
  const float disc = __fmaf_rn(b, b, -(d2 * cc));
  const float sq = sqrtf(max_nan(disc, 0.0f));
  const float den = max_nan(d2, 1e-30f);
  const float t0 = (-b - sq) / den;
  const float t1 = (-b + sq) / den;
  t = t0 >= 0.0f ? t0 : t1;
  return disc >= 0.0f && t >= 0.0f;
}

// geometry.ray_triangle (Moller-Trumbore, 3-D), fused order: jnp.cross's
// fma(x_j, y_k, -(x_k * y_j)) and dots whose first product is added to +0
__device__ __forceinline__ bool ray_triangle(const float (&o)[3],
                                             const float (&dir)[3],
                                             const float (&a)[3],
                                             const float (&pb)[3],
                                             const float (&pc)[3], float& t) {
  float e1[3], e2[3], tv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e1[c] = pb[c] - a[c];
    e2[c] = pc[c] - a[c];
    tv[c] = o[c] - a[c];
  }
  const float* d = dir;
  const float p[3] = {__fmaf_rn(d[1], e2[2], -(d[2] * e2[1])),
                      __fmaf_rn(d[2], e2[0], -(d[0] * e2[2])),
                      __fmaf_rn(d[0], e2[1], -(d[1] * e2[0]))};
  const float qv[3] = {__fmaf_rn(tv[1], e1[2], -(tv[2] * e1[1])),
                       __fmaf_rn(tv[2], e1[0], -(tv[0] * e1[2])),
                       __fmaf_rn(tv[0], e1[1], -(tv[1] * e1[0]))};
  const float det = __fmaf_rn(e1[2], p[2],
                              __fmaf_rn(e1[1], p[1], __fmaf_rn(e1[0], p[0], 0.0f)));
  const float tiny = det >= 0.0f ? 1e-12f : -1e-12f;
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? tiny : det);
  const float u = __fmaf_rn(tv[2], p[2], __fmaf_rn(tv[1], p[1],
                  __fmaf_rn(tv[0], p[0], 0.0f))) * inv_det;
  const float v = __fmaf_rn(d[2], qv[2], __fmaf_rn(d[1], qv[1],
                  __fmaf_rn(d[0], qv[0], 0.0f))) * inv_det;
  t = __fmaf_rn(e2[2], qv[2], __fmaf_rn(e2[1], qv[1],
      __fmaf_rn(e2[0], qv[0], 0.0f))) * inv_det;
  constexpr float kOne = static_cast<float>(1.0 + 1e-7);
  return fabsf(det) > 1e-12f && u >= -1e-7f && v >= -1e-7f && u + v <= kOne &&
         t >= 0.0f;
}

// Value records of a 3-D tree in sorted-leaf order (pack_values): a
// sphere is one record (c.xyz, r); a triangle three, (a.xyz, original
// index), (b.xyz, 0), (c.xyz, 0). The floats are bit-cast to int32. The
// original index of a leaf also sits in its node record (leaf_perm).
__device__ __forceinline__ void xyz_of(const int4 v, float (&p)[3]) {
  p[0] = __int_as_float(v.x);
  p[1] = __int_as_float(v.y);
  p[2] = __int_as_float(v.z);
}

// a 3-D ray against leaf `pos`'s sphere: true on a hit, with its t
__device__ __forceinline__ bool sphere_record_hit(
    const Ray3& ray, const int4* __restrict__ vrec, int pos, float& t) {
  const int4 v = __ldg(vrec + pos);
  float cen[3];
  xyz_of(v, cen);
  return ray_sphere(
      ray.o, [&](int c) { return ray.d[c]; }, [&](int c) { return cen[c]; },
      __int_as_float(v.w), 3, t);
}

// a 3-D ray against leaf `pos`'s triangle: true on a hit, with its t
__device__ __forceinline__ bool triangle_record_hit(
    const Ray3& ray, const int4* __restrict__ vrec, int pos, float& t) {
  const long long at = 3 * static_cast<long long>(pos);
  float a[3], b[3], c[3];
  xyz_of(__ldg(vrec + at), a);
  xyz_of(__ldg(vrec + at + 1), b);
  xyz_of(__ldg(vrec + at + 2), c);
  return ray_triangle(ray.o, ray.d, a, b, c, t);
}
