// The k nearest values by FINE distance (Nearest over Spheres, Triangles,
// Segments, Tetrahedra and KDOPs values): the k-nearest rope walk with the
// distance from the query to the value itself as its key.
//
// Replaces: the reference's Nearest path over these values, the loop
//   route of src/repro/core/bvh.py::_knn_impl (:215; engine.py:582 for the
//   serving cache), which compiles core/traversal.py::traverse_knn into
//   one lax.while_loop program on the device (no pl.pallas_call of its
//   own; its Pallas kNN kernel,
//   kernels/bvh_traverse.py::bvh_traverse_knn, takes Points and Boxes
//   values only). Its rope walk: at a node, the key is the query's
//   predicates.node_min_distance to the node box (a point's or a
//   centroid's distance, a sphere's less its radius, clamped at 0, a
//   box's box-to-box distance); descend to the left child while the key
//   is strictly below the running k-th best (tau), else escape by the
//   rope; at a leaf, admit the value when its box key and its fine
//   distance from the query centroid (predicates.leaf_distance in the
//   "walk" order: a sphere's centre distance less its radius, clamped at
//   0; geometry.distance_point_triangle / distance_point_segment; the
//   bounding box of a tetrahedron or a k-DOP) are both below tau, placed
//   before the equal entries.
// Bound on this card: the ray kNN walk's pointer chase (ray_knn.cu) over
//   the tree's node records at data-dependent addresses, pruned by the
//   running k-th best once k values are held; a leaf adds its value
//   record (16 bytes a sphere or vertex) and a few dozen to a few hundred
//   float operations (a triangle's barycentric test and three segments).
//   Latency-bound.
// Design: one thread walks one query through the twin's node sequence
//   with the twin's running k-th best: rope_knn.cuh's rope walk, shared
//   with the ray kNN walk, with this file's node key and leaf distance
//   (knn_list.cuh: KeyList in registers up to k = 32, KeyHeap in local
//   memory up to KNN_MAX_K = 256), so the lists equal the twin's bit for
//   bit, ties and the (inf, -1) padding included, by
//   construction. It keeps the rope walk and not the nearest-first walk
//   of bvh_traverse.cu: a fine distance can round below the box key of
//   its own leaf (the nearest point of a triangle lies in its box only in
//   exact arithmetic), so which such leaves the twin keeps depends on its
//   visit order, as for the ray walk's sphere and triangle hits. The
//   point tests are point_tests.cuh's, the "walk" order, which the
//   callback kernel shares. In 3-D the walk reads LBVH.records (two
//   16-byte records a node, (lo.xyz, rope) and (hi.xyz, left child |
//   leaf_perm)) and the value records of Spheres, Triangles and Segments
//   in sorted-leaf order (bvh_traverse.pack_values), with no leaf_perm
//   gather; a Tetrahedra or KDOPs leaf's distance is the centroid's
//   distance to its node box. Other dims (1..16) read the flat node
//   arrays and gather a value through leaf_perm.
#include "common.cuh"
#include "point_tests.cuh"
#include "ray_tests.cuh"
#include "rope_knn.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 256;   // queries per block
constexpr int kMaxK = 256;      // the largest k (KNN_MAX_K)
enum Kind {
  kSpheres = 2,
  kTriangles = 3,
  kSegments = 5,
  kTetrahedra = 6,
  kKDOPs = 7
};

// the node loaders of rope_knn.cuh, named here for the kernel instances
struct Records3 : knn::NodeRecords3 {};
struct Flat : knn::NodeFlat<kMaxDim> {};

// The values: in 3-D the value records in sorted-leaf order (`rec`,
// pack_values' layout: `stride` records a leaf), in other dims the value
// arrays gathered by the original index (a, b, c; a sphere's centre in a
// and radius in r).
struct Values {
  const int4* __restrict__ rec;
  const float* __restrict__ a;
  const float* __restrict__ b;
  const float* __restrict__ c;
  const float* __restrict__ r;
  int stride;
  int dim;
  int kind;

  // component k of vertex j of value `orig` (a sphere's centre is vertex
  // 0), from the value arrays
  __device__ __forceinline__ float vert(int orig, int j, int k) const {
    const float* base = j == 0 ? a : j == 1 ? b : c;
    return __ldg(base + static_cast<long long>(orig) * dim + k);
  }
};

// the fine distance of leaf `pos` (original index `orig`, box [lo, hi])
// from the query centroid qc, "walk" order: vertices through vert(j, c),
// a sphere's radius through rad()
template <int N, class Vert, class Rad>
__device__ __forceinline__ float fine_distance(int kind, Vert vert, Rad rad,
                                               const float (&qc)[N],
                                               const float (&lo)[N],
                                               const float (&hi)[N],
                                               int dim) {
  auto q = [&](int c) { return qc[c]; };
  auto va = [&](int c) { return vert(0, c); };
  auto vb = [&](int c) { return vert(1, c); };
  auto vc = [&](int c) { return vert(2, c); };
  if (kind == kSegments) return pt::segment<false, N>(q, va, vb, dim);
  if (kind == kTriangles) return pt::triangle<N>(q, va, vb, vc, dim);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      // a sphere: the centre distance; a tetrahedron or a k-DOP: the
      // distance to its bounding box, the leaf's node box
      const float g = kind == kSpheres
                          ? qc[c] - vert(0, c)
                          : max_nan(max_nan(lo[c] - qc[c], qc[c] - hi[c]),
                                    0.0f);
      s = c == 0 ? g * g : __fmaf_rn(g, g, s);
    }
  }
  const float d = sqrtf(s);
  return kind == kSpheres ? max_nan(d - rad(), 0.0f) : d;
}

template <int N>
__device__ __forceinline__ float leaf_distance(const Values& v, int pos,
                                               int orig, const float (&qc)[N],
                                               const float (&lo)[N],
                                               const float (&hi)[N],
                                               int dim) {
  if constexpr (N == 3) {
    // the leaf's value record(s) in registers: one 16-byte load each
    float w[3][3] = {};
    float r = 0.0f;
    if (v.kind != kTetrahedra && v.kind != kKDOPs) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < v.stride) {
          const int4 x =
              __ldg(v.rec + static_cast<long long>(v.stride) * pos + j);
          xyz_of(x, w[j]);
          if (j == 0) r = __int_as_float(x.w);
        }
      }
    }
    return fine_distance<3>(
        v.kind, [&](int j, int c) { return w[j][c]; }, [&]() { return r; },
        qc, lo, hi, dim);
  } else {
    return fine_distance<N>(
        v.kind, [&](int j, int c) { return v.vert(orig, j, c); },
        [&]() { return __ldg(v.r + orig); }, qc, lo, hi, dim);
  }
}

// one query's walk: the node key is predicates.node_min_distance from
// the query box [ql, qh] (a sphere query's less its radius), the leaf key
// the fine distance from the centroid qc; `lo` / `hi` keep the last
// node's box, which a Tetrahedra or KDOPs leaf's distance reads
template <class Nodes>
struct FineWalk {
  static constexpr int N = Nodes::N;
  const Nodes& nodes;
  const Values& vals;
  int dim;
  const float* radius;
  float qr;
  float ql[N], qh[N], qc[N];
  float lo[N], hi[N];

  __device__ __forceinline__ float key(int m, int& link, int& rope) {
    nodes.load(m, dim, lo, hi, link, rope);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < dim) {
        const float g = max_nan(max_nan(lo[c] - qh[c], ql[c] - hi[c]), 0.0f);
        s = c == 0 ? g * g : __fmaf_rn(g, g, s);
      }
    }
    const float key = sqrtf(s);
    return radius != nullptr ? max_nan(key - qr, 0.0f) : key;
  }
  __device__ __forceinline__ float leaf(int pos, int link, float) const {
    return leaf_distance<N>(vals, pos, link, qc, lo, hi, dim);
  }
};

template <class Nodes, class List>
__global__ void __launch_bounds__(kThreads)
    fine_knn_kernel(Nodes nodes, Values vals, const int* __restrict__ perm,
                    int n, int dim, const float* __restrict__ q_lo,
                    const float* __restrict__ q_hi,
                    const float* __restrict__ center,
                    const float* __restrict__ radius, int q, int k,
                    float* __restrict__ dists, int* __restrict__ idxs) {
  constexpr int N = Nodes::N;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  FineWalk<Nodes> walk{nodes, vals, dim, radius,
                       radius == nullptr ? 0.0f : __ldg(radius + qi)};
  const long long qo = static_cast<long long>(qi) * dim;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < dim) {
      walk.ql[c] = __ldg(q_lo + qo + c);
      walk.qh[c] = __ldg(q_hi + qo + c);
      walk.qc[c] = __ldg(center + qo + c);
    }
  }
  List best;
  knn::rope_walk(walk, n, k, best);
  knn::put_list(best, k, perm, dists + static_cast<long long>(qi) * k,
                idxs + static_cast<long long>(qi) * k);
}

struct Call {
  const int* perm;
  int n, dim;
  const float *q_lo, *q_hi, *center, *radius;
  int q, k;
  float* dists;
  int* idxs;
  cudaStream_t stream;
};

template <class Nodes>
cudaError_t launch_k(const Nodes& nodes, const Values& vals, const Call& c) {
  return knn::with_list<kMaxK>(c.k, [&](auto tag) {
    using List = typename decltype(tag)::type;
    const int blocks = (c.q + kThreads - 1) / kThreads;
    fine_knn_kernel<Nodes, List><<<blocks, kThreads, 0, c.stream>>>(
        nodes, vals, c.perm, c.n, c.dim, c.q_lo, c.q_hi, c.center, c.radius,
        c.q, c.k, c.dists, c.idxs);
  });
}

}  // namespace

// dists / idxs: (q, k) float32 / int32 outputs. records: the (2n-1, 8)
// int32 node records of a 3-D tree (LBVH.records), or null for the flat
// arrays (node_lo ... perm). vrec: with records, the value records of
// Spheres (4 int32 a leaf), Segments (8) or Triangles (12) in sorted-leaf
// order (pack_values), else null; val_a / val_b / val_c / val_r: without
// records, the value arrays (a sphere's centre and radius in a and r).
// val_kind: Spheres, Triangles, Segments, Tetrahedra (3-D) or KDOPs.
// q_lo / q_hi: the query boxes of the node key ((q, dim); a point's or a
// centroid's lo = hi), center: the query centroids of the leaf distance,
// radius: a Spheres query's radii (q,), else null.
REPRO_EXPORT int fine_knn_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* perm, const void* records,
    const void* vrec, const void* val_a, const void* val_b,
    const void* val_c, const void* val_r, const void* q_lo, const void* q_hi,
    const void* center, const void* radius, int n, int q, int dim,
    int val_kind, int k, void* dists, void* idxs, void* stream) {
  const bool read = val_kind == kSpheres || val_kind == kTriangles ||
                    val_kind == kSegments;
  const bool flat_ok =
      val_kind == kSpheres ? val_a != nullptr && val_r != nullptr
      : val_kind == kSegments ? val_a != nullptr && val_b != nullptr
      : val_kind == kTriangles
          ? val_a != nullptr && val_b != nullptr && val_c != nullptr
          : true;
  if (dim < 1 || dim > kMaxDim || k < 1 || k > kMaxK || n < 2 ||
      (val_kind != kSpheres && val_kind != kTriangles &&
       val_kind != kSegments && val_kind != kTetrahedra &&
       val_kind != kKDOPs) ||
      (val_kind == kTetrahedra && dim != 3) ||
      (records != nullptr && dim != 3) ||
      (records != nullptr && read && vrec == nullptr) ||
      (records == nullptr && !flat_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int stride = val_kind == kTriangles ? 3 : val_kind == kSegments ? 2
                                                                        : 1;
  const Values vals{records != nullptr ? static_cast<const int4*>(vrec)
                                       : nullptr,
                    static_cast<const float*>(val_a),
                    static_cast<const float*>(val_b),
                    static_cast<const float*>(val_c),
                    static_cast<const float*>(val_r), stride, dim, val_kind};
  const Call c{static_cast<const int*>(perm), n, dim,
               static_cast<const float*>(q_lo),
               static_cast<const float*>(q_hi),
               static_cast<const float*>(center),
               static_cast<const float*>(radius), q, k,
               static_cast<float*>(dists), static_cast<int*>(idxs),
               static_cast<cudaStream_t>(stream)};
  if (records != nullptr) {
    return static_cast<int>(
        launch_k(Records3{{static_cast<const int4*>(records)}}, vals, c));
  }
  const Flat nodes{{static_cast<const float*>(node_lo),
                    static_cast<const float*>(node_hi),
                    static_cast<const int*>(rope),
                    static_cast<const int*>(left),
                    static_cast<const int*>(perm), n}};
  return static_cast<int>(launch_k(nodes, vals, c));
}
