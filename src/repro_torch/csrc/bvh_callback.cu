// Rope-walk BVH traversal with a callback applied in the epilogue, early
// exit by `done`.
//
// Replaces: src/repro/kernels/bvh_callback.py::bvh_traverse_callback (body
//   _callback_kernel), for Intersects predicates (Points, Boxes, Spheres,
//   and Triangles, Segments or Tetrahedra queries by their bounding
//   boxes) over Points, Boxes, Spheres, Triangles, Segments, Tetrahedra
//   and KDOPs values, and for the ray predicates (RayIntersect,
//   RayOrderedIntersect, RayNearest) over Points, Boxes, Spheres and 3-D
//   Triangles values. The TPU kernel traced the user's callback into a
//   block of lockstep cursors with the tree staged in VMEM; here each
//   callback the kernel runs is a fixed epilogue (a template parameter,
//   one instance per kind of repro_torch.core.callbacks), and one thread
//   walks one query's cursor: the node sequence of traversal.walk and of
//   bvh_traverse_spatial (descend left while the node test and the
//   range_last > min_pos filter pass, else escape by the rope).
// Bound on this card: the same pointer chase as bvh_traverse.cu, a
//   node box (2 * dim floats) and an int32 or two per visited node at a
//   data-dependent address; a leaf adds the value's geometry and, for
//   the min_where epilogue, one weight. Latency-bound.
// Design: tree, values and the min_where weights are read through __ldg
//   from global memory, with no node cap; the query geometry and the
//   scalar state live in registers; collect_* epilogues write their
//   slots straight into the (Q, cap) state outputs, which the wrapper
//   fills with the initial state. Thread i walks query order[i] where
//   the wrapper gives an order (the tree's leaf order, i.e. the Morton
//   order, when the queries are centred on the indexed points, so a warp
//   walks 32 neighbouring queries through the same nodes), else query i,
//   and reads and writes only that query's row. min_where takes one int32 per value, the
//   wrapper's where(flags, weights, big). Spatial walk (callback_kernel):
//   node test the predicate geometry's own test against the node box
//   (point in box, box overlap, or the squared sphere-box distance);
//   leaf test predicates.leaf_match_test of the (predicate, value) pair.
//   Squared sums are g0*g0 then one __fmaf_rn per further dimension under
//   --fmad=false, sqrtf is IEEE: the order of geometry.sum_sq_fused.
//   The dim = 3 instance (callback_kernel3) reads each node as two
//   16-byte records, (lo, rope) and (hi, left child or leaf_perm), one
//   vector load each; range_last only where the box overlaps and a
//   min_pos filter is set. Over Points and Boxes values the leaf box is
//   the value's own box, so the node test already computed the leaf test
//   (a point over a point: p <= q <= p is p == q; a sphere over a point:
//   max(max(p - q, q - p), 0)^2 is (q - p)^2 bit for bit, so sqrt(d2) <= r
//   needs no gather). Triangles, Segments, Tetrahedra and KDOPs values
//   (shaped_test) take predicates.leaf_match_test's branches in the
//   "walk" order of point_tests.cuh: a point in a triangle (by its
//   projection) or a tetrahedron, a sphere's centre within r of a
//   triangle or a segment, and the reference's box fallbacks, whose
//   value box is the leaf's node box (a point over a segment or a k-DOP,
//   any box query: the node test at the leaf; a sphere over a tetrahedron
//   or a k-DOP: its box [c - r, c + r]). In 3-D they walk their own
//   instance (shaped_kernel3), which reads a leaf's vertices from its
//   value records in sorted-leaf order and only where the test needs
//   them, so callback_kernel3 keeps its registers. Ray walks (ray_kernel3
//   in 3-D, ray_kernel in the other dims, where there are no triangles;
//   their own instances, so the spatial ones keep their registers): thread
//   i walks ray i; the origin and 1/d sit in registers with a bit per zero
//   direction component (the 3-D instance keeps the direction there too;
//   the other reads it at a sphere leaf); node test the slab test of
//   geometry.ray_box, leaf test predicates.leaf_ray_hit in the "walk" order
//   (ray_tests.cuh, shared with the ray kNN walk of ray_knn.cu); the hit's
//   t goes to the epilogue. The walk stays the rope walk: collect_* fill
//   their slots in walk order, which the twin and cast_intersect's CSR
//   order fix. The 3-D instance reads the node records as callback_kernel3
//   does and, for Spheres and Triangles, the leaf's value records in
//   sorted-leaf order (one or three 16-byte loads, no leaf_perm gather); a
//   Points or Boxes leaf takes its hit and t from the node test at the leaf
//   (the same slab over the same box); range_last only where a min_pos
//   filter is set, which no ray call does. States equal the twin's bit for
//   bit.
#include <cmath>

#include "common.cuh"
#include "point_tests.cuh"
#include "ray_tests.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 256;     // queries per block: block_q's default
constexpr int kMaxThreads = 512;  // the largest block_q an instance takes
enum Kind {
  kPoints = 0,
  kBoxes = 1,
  kSpheres = 2,
  kTriangles = 3,
  kRays = 4,
  kSegments = 5,
  kTetrahedra = 6,
  kKDOPs = 7
};

// values whose fine test is not one of the box and centre-distance tests
// of Points, Boxes and Spheres
__host__ __device__ __forceinline__ bool shaped(int kind) {
  return kind == kTriangles || kind >= kSegments;
}

struct Tree {
  const float* __restrict__ lo;          // (2n-1, dim)
  const float* __restrict__ hi;          // (2n-1, dim)
  const int* __restrict__ rope;          // (2n-1,)
  const int* __restrict__ left;          // (n-1,)
  const int* __restrict__ range_last;    // (2n-1,)
  const int* __restrict__ perm;          // (n,)
  int n;
  int dim;
};

// A geometry array: Points (a = coords), Boxes (a = lo, b = hi), Spheres
// (a = center, r = radius), Triangles (a, b, c), Segments (a, b),
// Tetrahedra (a, b, c, d), KDOPs (none: a k-DOP's test is its bounding
// box, the leaf's node box) or Rays (a = origin, b = direction).
struct Geom {
  const float* __restrict__ a;
  const float* __restrict__ b;
  const float* __restrict__ c;
  const float* __restrict__ d;
  const float* __restrict__ r;
  int kind;
};

// the fine test of a Points or Spheres query (centre q, radius qr) against
// a Triangles, Segments, Tetrahedra or KDOPs value, in the "walk" order of
// point_tests.cuh: a point in a triangle (by projection) or tetrahedron;
// a sphere's centre within qr of a triangle or segment; else the bounding
// boxes (the value's is the leaf's node box [lo, hi], the sphere's
// [q - qr, q + qr]), which for a point is the node test at the leaf.
// vert(j, c) gives component c of the value's vertex j.
template <int N, class Q, class Lo, class Hi, class V>
__device__ __forceinline__ bool shaped_test(int pkind, int vkind, Q q,
                                            float qr, Lo lo, Hi hi, V vert,
                                            int dim) {
  auto a = [&](int c) { return vert(0, c); };
  auto b = [&](int c) { return vert(1, c); };
  auto cc = [&](int c) { return vert(2, c); };
  if (pkind == kPoints) {
    if (vkind == kTriangles) return pt::in_triangle<N>(q, a, b, cc, dim);
    if (vkind == kTetrahedra) {
      float p3[3], v[4][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p3[c] = q(c);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j][c] = vert(j, c);
      }
      return pt::in_tetrahedron(p3, v[0], v[1], v[2], v[3]);
    }
    return true;
  }
  if (vkind == kTriangles) return pt::triangle<N>(q, a, b, cc, dim) <= qr;
  if (vkind == kSegments) return pt::segment<false, N>(q, a, b, dim) <= qr;
  bool fine = true;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) fine = fine && q(c) - qr <= hi(c) && lo(c) <= q(c) + qr;
  }
  return fine;
}

// ---------------------------------------------------------------------------
// epilogues: load the state, apply one hit (returns done), store
// ---------------------------------------------------------------------------

struct Counting {
  int* s;
  int c;
  __device__ void load(int qi) { c = s[qi]; }
  __device__ bool hit(int, int, float) { ++c; return false; }
  __device__ void store(int qi) { s[qi] = c; }
};

struct CountWithLimit {
  int* s;
  int limit;
  int c;
  __device__ void load(int qi) { c = s[qi]; }
  __device__ bool hit(int, int, float) { ++c; return c >= limit; }
  __device__ void store(int qi) { s[qi] = c; }
};

struct MinDistance {
  float* s;
  float m;
  __device__ void load(int qi) { m = s[qi]; }
  __device__ bool hit(int, int, float t) { m = min_nan(m, t); return false; }
  __device__ void store(int qi) { s[qi] = m; }
};

// collect_first_k (stops counting at k) and collect_hits (counts on past
// capacity): slot c of the query's row takes the hit while c < width
template <bool kFirstK>
struct Collect {
  int* count;
  int* idxs;      // (q, width)
  float* ts;      // (q, width)
  int width;
  int early_exit;
  int c;
  __device__ void load(int qi) { c = count[qi]; }
  __device__ bool hit(int qi, int orig, float t) {
    if (c < width) {
      const long long o = static_cast<long long>(qi) * width + c;
      idxs[o] = orig;
      ts[o] = t;
      ++c;
    } else if (!kFirstK) {
      ++c;
    }
    return kFirstK && early_exit && c >= width;
  }
  __device__ void store(int qi) { count[qi] = c; }
};

// min(state, w[orig]) with w = where(flags, weights, big) from the
// wrapper: one gather
struct MinWhere {
  int* s;
  const int* __restrict__ weights;   // (n,)
  int m;
  __device__ void load(int qi) { m = s[qi]; }
  __device__ bool hit(int, int orig, float) {
    m = min(m, __ldg(weights + orig));
    return false;
  }
  __device__ void store(int qi) { s[qi] = m; }
};

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

// the query thread i walks: order[i], or i without an order
__device__ __forceinline__ int query_of(const int* __restrict__ order,
                                        int i) {
  return order == nullptr ? i : __ldg(order + i);
}

template <int kBound, class Ep>
__global__ void __launch_bounds__(kBound)
    callback_kernel(Tree t, Geom pg, Geom vg,
                                const int* __restrict__ order,
                                const int* __restrict__ min_pos, int q,
                                const Ep ep0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int qi = query_of(order, i);
  const int dim = t.dim;
  float qa[kMaxDim], qb[kMaxDim];
#pragma unroll
  for (int c = 0; c < kMaxDim; ++c) {
    if (c < dim) {
      qa[c] = pg.a[static_cast<long long>(qi) * dim + c];
      qb[c] = pg.kind == kBoxes ? pg.b[static_cast<long long>(qi) * dim + c]
                                : qa[c];
    }
  }
  const float qr = pg.kind == kSpheres ? pg.r[qi] : 0.0f;
  const float qr2 = qr * qr;
  const int mp = min_pos[qi];
  Ep ep = ep0;
  ep.load(qi);

  int node = 0;
  bool done = false;
  while (node != -1 && !done) {
    const float* lo = t.lo + static_cast<long long>(node) * dim;
    const float* hi = t.hi + static_cast<long long>(node) * dim;
    bool overlap = true;
    if (pg.kind == kSpheres) {
      float d2 = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxDim; ++c) {
        if (c < dim) {
          const float g = max_nan(max_nan(__ldg(lo + c) - qa[c],
                                          qa[c] - __ldg(hi + c)), 0.0f);
          d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
        }
      }
      overlap = d2 <= qr2;
    } else {
      // a point is the box [p, p]: lo <= q_hi and q_lo <= hi per axis
#pragma unroll
      for (int c = 0; c < kMaxDim; ++c) {
        if (c < dim) {
          overlap = overlap && __ldg(lo + c) <= qb[c] && qa[c] <= __ldg(hi + c);
        }
      }
    }
    if (node < t.n - 1) {
      node = overlap && __ldg(t.range_last + node) > mp ? __ldg(t.left + node)
                                                        : __ldg(t.rope + node);
      continue;
    }
    const int pos = node - (t.n - 1);
    if (overlap && pos > mp) {
      const int orig = __ldg(t.perm + pos);
      const long long vo = static_cast<long long>(orig) * dim;
      bool fine = true;
      if (shaped(vg.kind)) {
        // a Boxes query (or a Triangles, Segments or Tetrahedra one, by
        // its box) meets the value's box: the node test at the leaf
        if (pg.kind != kBoxes) {
          const float* verts[4] = {vg.a, vg.b, vg.c, vg.d};
          fine = shaped_test<kMaxDim>(
              pg.kind, vg.kind, [&](int c) { return qa[c]; }, qr,
              [&](int c) { return __ldg(lo + c); },
              [&](int c) { return __ldg(hi + c); },
              [&](int j, int c) { return __ldg(verts[j] + vo + c); }, dim);
        }
      } else if (pg.kind == kBoxes ||
                 (pg.kind == kPoints && vg.kind != kSpheres)) {
        // box overlap with the value's bounding box (to_boxes); a point
        // predicate is the box [p, p] and a point value the box [v, v]
        const float vr = vg.kind == kSpheres ? __ldg(vg.r + orig) : 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxDim; ++c) {
          if (c < dim) {
            const float a = __ldg(vg.a + vo + c);
            float vlo = a, vhi = a;
            if (vg.kind == kBoxes) vhi = __ldg(vg.b + vo + c);
            if (vg.kind == kSpheres) { vlo = a - vr; vhi = a + vr; }
            if (pg.kind == kPoints && vg.kind == kPoints) {
              fine = fine && a == qa[c];
            } else {
              fine = fine && qa[c] <= vhi && vlo <= qb[c];
            }
          }
        }
      } else if (vg.kind == kBoxes) {
        // a sphere over a box: squared distance from the centre
        float d2 = 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxDim; ++c) {
          if (c < dim) {
            const float g = max_nan(max_nan(__ldg(vg.a + vo + c) - qa[c],
                                            qa[c] - __ldg(vg.b + vo + c)),
                                    0.0f);
            d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
          }
        }
        fine = d2 <= qr2;
      } else {
        // centre distances, sqrt form: a sphere over a point, a point in
        // a sphere, a sphere over a sphere
        float d2 = 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxDim; ++c) {
          if (c < dim) {
            const float g = qa[c] - __ldg(vg.a + vo + c);
            d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
          }
        }
        float lim = qr;
        if (vg.kind == kSpheres) {
          lim = pg.kind == kPoints ? __ldg(vg.r + orig) : qr + __ldg(vg.r + orig);
        }
        fine = sqrtf(d2) <= lim;
      }
      if (fine) done = ep.hit(qi, orig, 0.0f);
    }
    node = __ldg(t.rope + node);
  }
  ep.store(qi);
}

// ---------------------------------------------------------------------------
// the spatial walk in 3-D over packed node records
// ---------------------------------------------------------------------------

// node k is records[2k] = (lo.xyz, rope) and records[2k + 1] = (hi.xyz,
// left child of an internal node or leaf_perm of a leaf), ints bit-cast
template <int kBound, class Ep>
__global__ void __launch_bounds__(kBound)
    callback_kernel3(const int4* __restrict__ records,
                     const int* __restrict__ range_last, int n, Geom pg,
                     Geom vg, const int* __restrict__ order,
                     const int* __restrict__ min_pos, int q, const Ep ep0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int qi = query_of(order, i);
  const long long qo = static_cast<long long>(qi) * 3;
  float qa[3], qb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    qa[c] = __ldg(pg.a + qo + c);
    qb[c] = pg.kind == kBoxes ? __ldg(pg.b + qo + c) : qa[c];
  }
  const float qr = pg.kind == kSpheres ? __ldg(pg.r + qi) : 0.0f;
  const float qr2 = qr * qr;
  const int mp = __ldg(min_pos + qi);
  // the leaf box is the value's own box: Points and Boxes values
  const bool reuse = vg.kind != kSpheres;
  Ep ep = ep0;
  ep.load(qi);

  int node = 0;
  bool done = false;
  while (node != -1 && !done) {
    const int4 ra = __ldg(records + 2 * static_cast<long long>(node));
    const int4 rb = __ldg(records + 2 * static_cast<long long>(node) + 1);
    const float lo[3] = {__int_as_float(ra.x), __int_as_float(ra.y),
                         __int_as_float(ra.z)};
    const float hi[3] = {__int_as_float(rb.x), __int_as_float(rb.y),
                         __int_as_float(rb.z)};
    bool overlap = true;
    float d2 = 0.0f;
    if (pg.kind == kSpheres) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g = max_nan(max_nan(lo[c] - qa[c], qa[c] - hi[c]), 0.0f);
        d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
      }
      overlap = d2 <= qr2;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        overlap = overlap && lo[c] <= qb[c] && qa[c] <= hi[c];
      }
    }
    if (node < n - 1) {
      node = overlap && (mp < 0 || __ldg(range_last + node) > mp) ? rb.w
                                                                  : ra.w;
      continue;
    }
    const int pos = node - (n - 1);
    if (overlap && pos > mp) {
      const int orig = rb.w;
      const long long vo = static_cast<long long>(orig) * 3;
      bool fine = true;
      if (reuse) {
        // box tests are the node test; a sphere over a point compares
        // the same d2 in sqrt form
        if (pg.kind == kSpheres && vg.kind == kPoints) fine = sqrtf(d2) <= qr;
      } else if (pg.kind == kBoxes ||
                 (pg.kind == kPoints && vg.kind != kSpheres)) {
        const float vr = vg.kind == kSpheres ? __ldg(vg.r + orig) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float a = __ldg(vg.a + vo + c);
          float vlo = a, vhi = a;
          if (vg.kind == kBoxes) vhi = __ldg(vg.b + vo + c);
          if (vg.kind == kSpheres) { vlo = a - vr; vhi = a + vr; }
          if (pg.kind == kPoints && vg.kind == kPoints) {
            fine = fine && a == qa[c];
          } else {
            fine = fine && qa[c] <= vhi && vlo <= qb[c];
          }
        }
      } else if (vg.kind == kBoxes) {
        float e2 = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float g = max_nan(max_nan(__ldg(vg.a + vo + c) - qa[c],
                                          qa[c] - __ldg(vg.b + vo + c)),
                                  0.0f);
          e2 = c == 0 ? g * g : __fmaf_rn(g, g, e2);
        }
        fine = e2 <= qr2;
      } else {
        float e2 = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float g = qa[c] - __ldg(vg.a + vo + c);
          e2 = c == 0 ? g * g : __fmaf_rn(g, g, e2);
        }
        float lim = qr;
        if (vg.kind == kSpheres) {
          lim = pg.kind == kPoints ? __ldg(vg.r + orig) : qr + __ldg(vg.r + orig);
        }
        fine = sqrtf(e2) <= lim;
      }
      if (fine) done = ep.hit(qi, orig, 0.0f);
    }
    node = ra.w;
  }
  ep.store(qi);
}

// ---------------------------------------------------------------------------
// the spatial walk in 3-D over Triangles, Segments, Tetrahedra and KDOPs
// ---------------------------------------------------------------------------

// records as callback_kernel3's; vrec the value records of Triangles,
// Segments or Tetrahedra in sorted-leaf order (three, two or four 16-byte
// records a leaf, ray_tests.cuh's layout), null for KDOPs, whose test is
// the leaf's node box. The query is a point, a box (Boxes, and the
// Triangles, Segments and Tetrahedra queries by their bounding boxes) or
// a sphere. Its own instance, so that callback_kernel3 keeps its
// registers.
template <int kBound, class Ep>
__global__ void __launch_bounds__(kBound)
    shaped_kernel3(const int4* __restrict__ records,
                   const int4* __restrict__ vrec,
                   const int* __restrict__ range_last, int n, Geom pg,
                   int val_kind, const int* __restrict__ min_pos, int q,
                   const Ep ep0) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const long long qo = static_cast<long long>(qi) * 3;
  float qa[3], qb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    qa[c] = __ldg(pg.a + qo + c);
    qb[c] = pg.kind == kBoxes ? __ldg(pg.b + qo + c) : qa[c];
  }
  const float qr = pg.kind == kSpheres ? __ldg(pg.r + qi) : 0.0f;
  const float qr2 = qr * qr;
  const int mp = __ldg(min_pos + qi);
  const int stride = val_kind == kTriangles ? 3 : val_kind == kSegments ? 2
                                                                        : 4;
  // the tests that read the value's vertices: a point in a triangle or a
  // tetrahedron, a sphere over a triangle or a segment
  const bool verts =
      pg.kind == kPoints ? val_kind == kTriangles || val_kind == kTetrahedra
                         : pg.kind == kSpheres && (val_kind == kTriangles ||
                                                   val_kind == kSegments);
  Ep ep = ep0;
  ep.load(qi);

  int node = 0;
  bool done = false;
  while (node != -1 && !done) {
    const int4 ra = __ldg(records + 2 * static_cast<long long>(node));
    const int4 rb = __ldg(records + 2 * static_cast<long long>(node) + 1);
    float lo[3], hi[3];
    xyz_of(ra, lo);
    xyz_of(rb, hi);
    bool overlap = true;
    if (pg.kind == kSpheres) {
      float d2 = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g = max_nan(max_nan(lo[c] - qa[c], qa[c] - hi[c]), 0.0f);
        d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
      }
      overlap = d2 <= qr2;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        overlap = overlap && lo[c] <= qb[c] && qa[c] <= hi[c];
      }
    }
    if (node < n - 1) {
      node = overlap && (mp < 0 || __ldg(range_last + node) > mp) ? rb.w
                                                                  : ra.w;
      continue;
    }
    const int pos = node - (n - 1);
    if (overlap && pos > mp) {
      bool fine = true;
      if (verts) {
        float v[4][3];
        const long long at = static_cast<long long>(stride) * pos;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < stride) xyz_of(__ldg(vrec + at + j), v[j]);
        }
        fine = shaped_test<3>(
            pg.kind, val_kind, [&](int c) { return qa[c]; }, qr,
            [&](int c) { return lo[c]; }, [&](int c) { return hi[c]; },
            [&](int j, int c) { return v[j][c]; }, 3);
      } else if (pg.kind == kSpheres) {
        fine = shaped_test<3>(
            pg.kind, val_kind, [&](int c) { return qa[c]; }, qr,
            [&](int c) { return lo[c]; }, [&](int c) { return hi[c]; },
            [&](int, int) { return 0.0f; }, 3);
      }
      if (fine) done = ep.hit(qi, rb.w, 0.0f);
    }
    node = ra.w;
  }
  ep.store(qi);
}

// ---------------------------------------------------------------------------
// the ray walk
// ---------------------------------------------------------------------------

// dims other than 3: Points, Boxes and Spheres values
template <int kBound, class Ep>
__global__ void __launch_bounds__(kBound)
    ray_kernel(Tree t, Geom pg, Geom vg,
                           const int* __restrict__ min_pos, int q,
                           const Ep ep0) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int dim = t.dim;
  const long long qo = static_cast<long long>(qi) * dim;
  RayReg<kMaxDim> ray;
  ray.load(pg.a + qo, pg.b + qo, dim);
  const int mp = min_pos[qi];
  Ep ep = ep0;
  ep.load(qi);

  int node = 0;
  bool done = false;
  while (node != -1 && !done) {
    float tn;
    const bool overlap = ray_slab(
        ray.o, ray.inv, ray.zero, t.lo + static_cast<long long>(node) * dim,
        t.hi + static_cast<long long>(node) * dim, dim, LoadLdg(), tn);
    if (node < t.n - 1) {
      node = overlap && __ldg(t.range_last + node) > mp ? __ldg(t.left + node)
                                                        : __ldg(t.rope + node);
      continue;
    }
    const int pos = node - (t.n - 1);
    if (overlap && pos > mp) {
      const int orig = __ldg(t.perm + pos);
      const long long vo = static_cast<long long>(orig) * dim;
      float th;
      bool hit;
      if (vg.kind == kPoints) {
        hit = ray_slab(ray.o, ray.inv, ray.zero, vg.a + vo, vg.a + vo, dim,
                       LoadLdg(), th);
      } else if (vg.kind == kBoxes) {
        hit = ray_slab(ray.o, ray.inv, ray.zero, vg.a + vo, vg.b + vo, dim,
                       LoadLdg(), th);
      } else {
        const float* cen = vg.a + vo;
        hit = ray_sphere(
            ray.o, [&](int c) { return __ldg(ray.dir + c); },
            [&](int c) { return __ldg(cen + c); }, __ldg(vg.r + orig), dim,
            th);
      }
      if (hit) done = ep.hit(qi, orig, th);
    }
    node = __ldg(t.rope + node);
  }
  ep.store(qi);
}

// ---------------------------------------------------------------------------
// the ray walk in 3-D over packed node and value records
// ---------------------------------------------------------------------------

// records as callback_kernel3's; vrec the value records of Spheres or
// Triangles values in sorted-leaf order (ray_tests.cuh), null for Points
// and Boxes, whose leaf test is the node test at the leaf (the slab over
// the same box gives the same t bit for bit). range_last is read only
// where a min_pos filter is set (no ray call sets one).
template <int kBound, class Ep>
__global__ void __launch_bounds__(kBound)
    ray_kernel3(const int4* __restrict__ records,
                const int4* __restrict__ vrec,
                const int* __restrict__ range_last, int n, Geom pg, Geom vg,
                const int* __restrict__ min_pos, int q, const Ep ep0) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const long long qo = static_cast<long long>(qi) * 3;
  Ray3 ray;
  ray.load(pg.a + qo, pg.b + qo, 3);
  const int mp = __ldg(min_pos + qi);
  Ep ep = ep0;
  ep.load(qi);

  int node = 0;
  bool done = false;
  while (node != -1 && !done) {
    const int4 ra = __ldg(records + 2 * static_cast<long long>(node));
    const int4 rb = __ldg(records + 2 * static_cast<long long>(node) + 1);
    float lo[3], hi[3];
    xyz_of(ra, lo);
    xyz_of(rb, hi);
    float tn;
    const bool overlap =
        ray_slab(ray.o, ray.inv, ray.zero, lo, hi, 3, LoadPlain(), tn);
    if (node < n - 1) {
      node = overlap && (mp < 0 || __ldg(range_last + node) > mp) ? rb.w
                                                                  : ra.w;
      continue;
    }
    const int pos = node - (n - 1);
    if (overlap && pos > mp) {
      float th = tn;
      bool hit = true;
      if (vg.kind == kSpheres) {
        hit = sphere_record_hit(ray, vrec, pos, th);
      } else if (vg.kind == kTriangles) {
        hit = triangle_record_hit(ray, vrec, pos, th);
      }
      if (hit) done = ep.hit(qi, rb.w, th);
    }
    node = ra.w;
  }
  ep.store(qi);
}

// everything of one call but the epilogue
struct Call {
  Tree t;
  Geom pg, vg;
  const int4* records;   // packed 3-D node records, or nullptr
  const int4* vrec;      // packed 3-D value records (rays), or nullptr
  const int* order;      // walk order of the Intersects queries, or nullptr
  const int* mp;
  int q;
  int threads;           // a block's queries, 1..kMaxThreads
  cudaStream_t stream;
};

// the walk's instances bounded at kBound threads a block
template <int kBound, class Ep>
void launch_bounded(const Call& c, const Ep& ep) {
  const int blocks = (c.q + c.threads - 1) / c.threads;
  if (c.pg.kind == kRays && c.records != nullptr) {
    ray_kernel3<kBound, Ep><<<blocks, c.threads, 0, c.stream>>>(
        c.records, c.vrec, c.t.range_last, c.t.n, c.pg, c.vg, c.mp, c.q, ep);
  } else if (c.pg.kind == kRays) {
    ray_kernel<kBound, Ep><<<blocks, c.threads, 0, c.stream>>>(
        c.t, c.pg, c.vg, c.mp, c.q, ep);
  } else if (c.records != nullptr && shaped(c.vg.kind)) {
    shaped_kernel3<kBound, Ep><<<blocks, c.threads, 0, c.stream>>>(
        c.records, c.vrec, c.t.range_last, c.t.n, c.pg, c.vg.kind, c.mp, c.q,
        ep);
  } else if (c.records != nullptr) {
    callback_kernel3<kBound, Ep><<<blocks, c.threads, 0, c.stream>>>(
        c.records, c.t.range_last, c.t.n, c.pg, c.vg, c.order, c.mp, c.q, ep);
  } else {
    callback_kernel<kBound, Ep><<<blocks, c.threads, 0, c.stream>>>(
        c.t, c.pg, c.vg, c.order, c.mp, c.q, ep);
  }
}

// up to kThreads a block the instances bounded there, else those at
// kMaxThreads
template <class Ep>
void launch(const Call& c, const Ep& ep) {
  if (c.threads <= kThreads) {
    launch_bounded<kThreads>(c, ep);
  } else {
    launch_bounded<kMaxThreads>(c, ep);
  }
}

enum Epilogue {
  kCounting = 0,
  kCountWithLimit = 1,
  kMinDistance = 2,
  kCollectFirstK = 3,
  kCollectHits = 4,
  kMinWhere = 5,
};

}  // namespace

// state0 / state1 / state2: the state leaves in place (filled with the
// initial state): int32 counts or float32 minima (Q,), then for collect_*
// int32 indices and float32 t (Q, param). param: the limit, k or capacity.
// pred_kind: Points, Boxes or Spheres (Intersects; the wrapper gives a
// Triangles, Segments or Tetrahedra query as its bounding boxes) or Rays;
// val_kind: Points, Boxes, Spheres, Triangles, Segments, Tetrahedra (3-D)
// or KDOPs under Intersects, and Points, Boxes, Spheres or Triangles (3-D)
// under Rays. val_a .. val_d: the value arrays (Kind's comment), val_r the
// radii. records: the (2n-1, 8) int32 node records of a 3-D tree (the
// dim = 3 instances; every 3-D ray call gives them), or null (the generic
// ones, from node_lo ... perm). vrec: with records, the value records of
// Spheres or Triangles values under Rays, and of Triangles, Segments or
// Tetrahedra values under Intersects (ray_tests.cuh's layout), else null.
// order: (q,) int32, the Intersects query each thread walks over Points,
// Boxes or Spheres values, or null. threads: a block's queries,
// 1..kMaxThreads. weights: min_where's (n,) int32 where(flags, weights,
// big).
REPRO_EXPORT int bvh_callback_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* range_last, const void* perm,
    const void* records, const void* vrec, const void* order,
    const void* pred_a,
    const void* pred_b, const void* pred_r, const void* val_a,
    const void* val_b, const void* val_c, const void* val_d,
    const void* val_r, const void* min_pos, int n, int q, int dim,
    int pred_kind, int val_kind, int epilogue, int param, int early_exit,
    int threads, void* state0, void* state1, void* state2,
    const void* weights, void* stream) {
  const bool ray = pred_kind == kRays;
  const bool shaped_v =
      val_kind == kTriangles || (val_kind >= kSegments && val_kind <= kKDOPs);
  if (dim < 1 || dim > kMaxDim || n < 2 || threads < 1 ||
      threads > kMaxThreads || pred_kind < 0 ||
      (pred_kind > kSpheres && !ray) || val_kind < 0 ||
      (ray ? val_kind > kTriangles : val_kind == kRays || val_kind > kKDOPs) ||
      (ray && val_kind == kTriangles && dim != 3) ||
      (val_kind == kTetrahedra && dim != 3) ||
      (records != nullptr && dim != 3) ||
      (ray && ((dim == 3) != (records != nullptr) || order != nullptr)) ||
      (ray && records != nullptr && val_kind >= kSpheres && vrec == nullptr) ||
      (!ray && shaped_v && order != nullptr) ||
      (!ray && records != nullptr && shaped_v && val_kind != kKDOPs &&
       vrec == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Call c{Tree{static_cast<const float*>(node_lo),
              static_cast<const float*>(node_hi),
              static_cast<const int*>(rope), static_cast<const int*>(left),
              static_cast<const int*>(range_last),
              static_cast<const int*>(perm), n, dim},
         Geom{static_cast<const float*>(pred_a),
              static_cast<const float*>(pred_b), nullptr, nullptr,
              static_cast<const float*>(pred_r), pred_kind},
         Geom{static_cast<const float*>(val_a), static_cast<const float*>(val_b),
              static_cast<const float*>(val_c), static_cast<const float*>(val_d),
              static_cast<const float*>(val_r), val_kind},
         static_cast<const int4*>(records), static_cast<const int4*>(vrec),
         static_cast<const int*>(order),
         static_cast<const int*>(min_pos), q, threads,
         static_cast<cudaStream_t>(stream)};
  auto s0 = static_cast<int*>(state0);
  switch (epilogue) {
    case kCounting:
      launch(c, Counting{s0, 0});
      break;
    case kCountWithLimit:
      launch(c, CountWithLimit{s0, param, 0});
      break;
    case kMinDistance:
      launch(c, MinDistance{static_cast<float*>(state0), 0.0f});
      break;
    case kCollectFirstK:
    case kCollectHits:
      if (param < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (epilogue == kCollectFirstK) {
        launch(c, Collect<true>{s0, static_cast<int*>(state1),
                                static_cast<float*>(state2), param, early_exit,
                                0});
      } else {
        launch(c, Collect<false>{s0, static_cast<int*>(state1),
                                 static_cast<float*>(state2), param, 0, 0});
      }
      break;
    case kMinWhere:
      launch(c, MinWhere{s0, static_cast<const int*>(weights), 0});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
