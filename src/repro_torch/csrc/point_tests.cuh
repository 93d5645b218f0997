// The point tests of segments, triangles and tetrahedra in the "walk"
// float order of geometry.ORDERS (the order XLA:CPU gives the reference's
// jitted walks, its callback kernel and its k-nearest walk), shared by the
// callback kernel's spatial walks (bvh_callback.cu) and the fine k-nearest
// walk (fine_knn.cu): distance_point_segment, distance_point_triangle,
// point_in_triangle and point_in_tetrahedron.
//
// Every library is built with --fmad=false: the only fused multiply-adds
// are the explicit __fmaf_rn below, and division and sqrtf are IEEE. The
// vectors are read through functors x(c) (registers or global memory), in
// any dim up to N.
#pragma once

#include <cmath>

#include "common.cuh"

namespace pt {

// geometry.dot: the first product added to +0, each later product fused
// into the sum (kFused) or rounded and added
template <bool kFused, int N, class X, class Y>
__device__ __forceinline__ float dot(X x, Y y, int dim) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      const float a = x(c), b = y(c);
      if (c == 0) {
        s = a * b + 0.0f;
      } else {
        s = kFused ? __fmaf_rn(a, b, s) : s + a * b;
      }
    }
  }
  return s;
}

// torch.clamp(x, 0, 1), NaN propagating
__device__ __forceinline__ float clamp01(float x) {
  return min_nan(max_nan(x, 0.0f), 1.0f);
}

// x * y - z * w as XLA:CPU fuses it: fma(x, y, -(z * w))
__device__ __forceinline__ float diff(float x, float y, float z, float w) {
  return __fmaf_rn(x, y, -(z * w));
}

// |p - proj(p, [a, b])|: p.ab and ab.ab rounded product by product, or
// fused (kDotsFused: a triangle's edges from a, whose dot products are
// the triangle's own), the projection fma(t, ab, a), the squared
// distance fused
template <bool kDotsFused, int N, class P, class A, class B>
__device__ __forceinline__ float segment(P p, A a, B b, int dim) {
  auto ab = [&](int c) { return b(c) - a(c); };
  auto pa = [&](int c) { return p(c) - a(c); };
  const float den = max_nan(dot<kDotsFused, N>(ab, ab, dim), 1e-30f);
  const float t = clamp01(dot<kDotsFused, N>(pa, ab, dim) / den);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      const float g = p(c) - __fmaf_rn(t, ab(c), a(c));
      s = c == 0 ? g * g : __fmaf_rn(g, g, s);
    }
  }
  return sqrtf(s);
}

// the barycentric coordinates (v, w) of p's projection on the plane of
// (a, b, c): a + v ab + w ac; the five dot products fused (kDotsFused:
// distance_point_triangle) or rounded product by product
// (point_in_triangle), the differences of products fused
template <bool kDotsFused, int N, class P, class A, class B, class C>
__device__ __forceinline__ void barycentric(P p, A a, B b, C c, int dim,
                                            float& v, float& w) {
  auto ab = [&](int k) { return b(k) - a(k); };
  auto ac = [&](int k) { return c(k) - a(k); };
  auto ap = [&](int k) { return p(k) - a(k); };
  const float d1 = dot<kDotsFused, N>(ab, ap, dim);
  const float d2 = dot<kDotsFused, N>(ac, ap, dim);
  const float d00 = dot<kDotsFused, N>(ab, ab, dim);
  const float d01 = dot<kDotsFused, N>(ab, ac, dim);
  const float d11 = dot<kDotsFused, N>(ac, ac, dim);
  const float denom = max_nan(diff(d00, d11, d01, d01), 1e-30f);
  v = diff(d11, d1, d01, d2) / denom;
  w = diff(d00, d2, d01, d1) / denom;
}

// geometry.distance_point_triangle: to the projection where it falls
// inside, else to the nearest edge (the edges from a fuse their dots)
template <int N, class P, class A, class B, class C>
__device__ __forceinline__ float triangle(P p, A a, B b, C c, int dim) {
  float v, w;
  barycentric<true, N>(p, a, b, c, dim, v, w);
  if (v >= 0.0f && w >= 0.0f && v + w <= 1.0f) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < dim) {
        const float proj =
            __fmaf_rn(w, c(k) - a(k), __fmaf_rn(v, b(k) - a(k), a(k)));
        const float g = p(k) - proj;
        s = k == 0 ? g * g : __fmaf_rn(g, g, s);
      }
    }
    return sqrtf(s);
  }
  return min_nan(segment<true, N>(p, a, b, dim),
                 min_nan(segment<false, N>(p, b, c, dim),
                         segment<true, N>(p, a, c, dim)));
}

// geometry.point_in_triangle: the projection within 1e-7 of the triangle
template <int N, class P, class A, class B, class C>
__device__ __forceinline__ bool in_triangle(P p, A a, B b, C c, int dim) {
  float v, w;
  barycentric<false, N>(p, a, b, c, dim, v, w);
  constexpr float kOne = static_cast<float>(1.0 + 1e-7);
  return v >= -1e-7f && w >= -1e-7f && v + w <= kOne;
}

// one face of point_in_tetrahedron: p and v3 on the same side of the
// plane of (v0, v1, v2), within the product slack -1e-9; the normal is
// jnp.cross's fma(x_j, y_k, -(x_k * y_j))
__device__ __forceinline__ bool same_side(const float (&v0)[3],
                                          const float (&v1)[3],
                                          const float (&v2)[3],
                                          const float (&v3)[3],
                                          const float (&p)[3]) {
  float e1[3], e2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e1[c] = v1[c] - v0[c];
    e2[c] = v2[c] - v0[c];
  }
  const float n[3] = {__fmaf_rn(e1[1], e2[2], -(e1[2] * e2[1])),
                      __fmaf_rn(e1[2], e2[0], -(e1[0] * e2[2])),
                      __fmaf_rn(e1[0], e2[1], -(e1[1] * e2[0]))};
  auto nn = [&](int c) { return n[c]; };
  const float s = dot<true, 3>(nn, [&](int c) { return v3[c] - v0[c]; }, 3);
  const float t = dot<true, 3>(nn, [&](int c) { return p[c] - v0[c]; }, 3);
  return s * t >= -1e-9f;
}

// geometry.point_in_tetrahedron (3-D)
__device__ __forceinline__ bool in_tetrahedron(const float (&p)[3],
                                               const float (&a)[3],
                                               const float (&b)[3],
                                               const float (&c)[3],
                                               const float (&d)[3]) {
  return same_side(a, b, c, d, p) && same_side(b, c, d, a, p) &&
         same_side(c, d, a, b, p) && same_side(d, a, b, c, p);
}

}  // namespace pt
