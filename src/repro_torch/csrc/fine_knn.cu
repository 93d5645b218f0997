// The k nearest values by FINE distance (Nearest over Spheres, Triangles,
// Segments, Tetrahedra and KDOPs values): a nearest-first walk whose lists
// are those of the reference's rope walk bit for bit, ties and the
// (inf, -1) padding included.
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
//   rope; at a leaf, admit the value when its box key kb and its fine
//   distance d from the query centroid (predicates.leaf_distance in the
//   "walk" order: a sphere's centre distance less its radius, clamped at
//   0; geometry.distance_point_triangle / distance_point_segment; the
//   bounding box of a tetrahedron or a k-DOP) are both below tau, placed
//   before the equal entries.
// Bound on this card: a pointer chase over the tree's node records at
//   data-dependent addresses, pruned by the running k-th best; a leaf adds
//   its value record (16 bytes a sphere or vertex) and a few dozen to a
//   few hundred float operations (a triangle's barycentric test and three
//   segments). Latency-bound: the time is the visits a query makes.
//
// What the rope walk's list is. Node keys never decrease down the tree: a
//   parent's box holds its child's (min / max are exact), and subtraction,
//   max, squares, FMA and sqrt are monotone under rounding. So when the
//   walk reaches leaf L, every ancestor's key is below the current tau as
//   soon as kb_L is, and the list is a scan over the leaves in ascending
//   sorted position with the running k-th best tau: L is admitted iff
//   kb_L < tau and d_L < tau (strict) and no key on its root path is NaN
//   or +inf (such a key prunes its subtree whatever tau is), and an
//   admitted leaf goes in before the equal entries. Call the leaves with a
//   finite, non-NaN root path E. Where d_L >= kb_L this is the point kNN
//   walk's rule, whose list does not depend on the visit order
//   (bvh_traverse.cu's note). The one departure is the ANOMALOUS leaf,
//   d_L < kb_L: the fine distance rounds below its own leaf box's key
//   (the computed closest point of a triangle lies in its box only in
//   exact arithmetic). Such a leaf is admitted iff kb_L < tau, so whether
//   it enters depends on what came before it.
// The slack delta (per query): d_L >= kb_L - delta for every leaf, with
//   M the largest magnitude among the query centroid's and the root box's
//   coordinates and u = 2^-24:
//   * Triangles and Segments values: the computed closest point P' is a
//     convex combination of the vertices up to rounding (a segment's t is
//     clamped to [0, 1]; the face branch is taken only for v, w >= 0 and
//     v + w <= 1 as computed, so a + v ab + w ac lies in the triangle up
//     to v + w <= 1 + u), at most about 8 u M a coordinate from it; the
//     box key rounds up by at most (dim + 2) u of the exact box distance,
//     the fine distance down by as much of |q - P'|, and both are at most
//     2 sqrt(dim) M. With the exact box distance at most the exact
//     distance to the value (the value lies in its box), kb - d <=
//     sqrt(dim) (4 dim + 18) u M: 52 u M in 3-D, 328 u M at dim 16.
//   * Spheres values: the box c -+ r rounds inward by at most u M a side
//     (sqrt(dim) u M in distance) and the centre distance rounds by
//     (dim + 3) u of at most 2 sqrt(dim) M: under the same bound. A
//     negative radius inverts the box, whose key then exceeds the centre
//     distance less r by up to (sqrt(dim) - 1) |r|: the wrapper passes
//     rneg = max(0, -min r) and delta adds 2 dim rneg.
//   * Tetrahedra and KDOPs values: the fine distance is the centroid's
//     distance to the leaf's own node box in the key's order, so for a
//     point query d == kb bit for bit; a box query's key is its
//     box-to-box distance, at most its centroid's (the centroid lies in
//     the box), and a sphere query's key its centre's less r >= 0: d >= kb
//     either way, and delta is 0 (the point walk's proof, no certificate).
//   * any query: an inverted query box (lo > hi) or a negative query
//     radius moves the key above the centroid's by up to the inversion or
//     |r|: delta adds twice their size (and the value term above).
//   delta = 2^-17 dim M + 2^-64 (+ the terms above), rounded up: 384 u M
//   in 3-D, seven times the bound; 2^-64 covers underflow. A delta that is
//   too large costs visits, never a list; a NaN delta (a NaN query or
//   scene) prunes the root, as the NaN key does in the rope walk.
// The walk (fine_nf_kernel): knn_walk.cuh's nearest-first order, one
//   thread a query: both children's keys, the nearer promising one next,
//   the farther stacked with its key and tested again when popped. A node
//   or leaf is pruned when its key is NaN, +inf or above tau + 2 delta
//   (rounded up): every leaf below then has d > tau + delta. A leaf is
//   offered by its fine distance alone (strict d < tau, placed before the
//   equal entries), so its list is that of the point walk's argument with
//   d as the key: every leaf of E with d below D, the final k-th distance,
//   and D itself, in any visit order. `lost` is the smallest d the walk
//   left out (a rejected or evicted leaf); when it equals D a tie pass
//   (a rope walk over the nodes keyed <= D, counting the leaves with
//   kb <= D and d <= D in position order) fills the slots at D as the
//   rope walk does. The list entries carry 2 pos + [d < kb].
// The certificate. Let T be the leaves of E with d <= D. Where every
//   anomalous leaf of T has kb < lost (>= D), the rope walk admits all of
//   T it must, in any order: its tau is at least the k-th smallest d of
//   the leaves it has not yet admitted, which for a leaf of T is D_{k+1},
//   the (k+1)-th smallest d of E, when T holds k leaves; lost <= D_{k+1}
//   or D_{k+1} lies in a pruned subtree, above D + delta >= kb_L. With
//   ties at D (T holds more than k), lost == D and the condition is kb < D
//   for the anomalous leaves of T, under which the tie rule above is the
//   rope walk's. So the lists are equal unless some visited anomalous leaf
//   has d <= D and kb >= lost. The thread checks it at the end: an
//   anomalous leaf it left out with d <= D (only at d == D: `lost_anom`,
//   the smallest d of the anomalous leaves it left out), or an anomalous
//   entry of its list whose kb, read again from its leaf node, is >= lost
//   (only entries with d + delta >= lost can be). A query that fails is
//   FLAGGED: its index goes to a device list (an atomic counter and the
//   indices, in scratch that the wrapper allocates) and the rope walk
//   itself (fine_rope_kernel, rope_knn.cuh's rope_walk, the twin's node
//   sequence) walks it next, on the same stream, with no host sync:
//   threads past the counter exit. The counter stays on the device for
//   tests to read. Flags need the (k+1)-th distance within a few ulps of
//   an anomalous entry's box key, so they are rare.
// Design on this card: the point tests are point_tests.cuh's, the "walk"
//   order, which the callback kernel shares. In 3-D the walk reads
//   LBVH.records (two 16-byte records a node, (lo.xyz, rope) and
//   (hi.xyz, left child | leaf_perm); a node's right child is its left
//   child's rope) and the value records of Spheres, Triangles and
//   Segments in sorted-leaf order (bvh_traverse.pack_values), with no
//   leaf_perm gather; a Tetrahedra or KDOPs leaf's distance is the
//   centroid's distance to its node box. Other dims (1..16) read the flat
//   node arrays and gather a value through leaf_perm. The list is KeyList
//   in registers up to k = 32, KeyHeap in local memory up to
//   KNN_MAX_K = 256 (knn_list.cuh); the stack (96 entries, knn_walk.cuh's
//   depth bound) in local memory. Levers measured and not kept
//   (scripts/fine_knn_variants.py): queries sorted by Morton code (the
//   walk a few per cent faster, the sort costing more than it saves),
//   128-thread blocks, and one warp a query (a node's right child comes
//   only from its left sibling's rope, so lanes can share no more than a
//   triangle's three edge tests: several times slower).
#include "common.cuh"
#include "point_tests.cuh"
#include "ray_tests.cuh"
#include "knn_walk.cuh"
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

  __device__ __forceinline__ void load_query(const float* q_lo,
                                             const float* q_hi,
                                             const float* center, int qi) {
    const long long qo = static_cast<long long>(qi) * dim;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < dim) {
        ql[c] = __ldg(q_lo + qo + c);
        qh[c] = __ldg(q_hi + qo + c);
        qc[c] = __ldg(center + qo + c);
      }
    }
  }
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
  // the slack delta of the note: d >= kb - delta for every leaf. `rneg`:
  // max(0, -min radius) of Spheres values, else null
  __device__ __forceinline__ float slack(const float* rneg) {
    int link, rope;
    key(0, link, rope);   // the root box, the scene
    float m = 0.0f, inv = 0.0f;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < dim) {
        m = max_nan(m, max_nan(fabsf(qc[c]),
                               max_nan(fabsf(lo[c]), fabsf(hi[c]))));
        inv = __fadd_ru(inv, max_nan(__fsub_ru(ql[c], qh[c]), 0.0f));
      }
    }
    const float rq = radius != nullptr ? max_nan(-qr, 0.0f) : 0.0f;
    const float rv = rneg != nullptr ? __ldg(rneg) : 0.0f;
    const float extra = __fmul_ru(2.0f, __fadd_ru(__fadd_ru(inv, rq),
                                                  __fmul_ru(dim, rv)));
    const bool exact = (vals.kind == kTetrahedra || vals.kind == kKDOPs) &&
                       extra == 0.0f;
    if (exact) return 0.0f;
    // 2^-17 dim M + 2^-64, rounded up
    const float base = __fmaf_ru(__fmul_ru(0x1p-17f, dim), m, 0x1p-64f);
    return __fadd_ru(base, extra);
  }
};

// a node or leaf key passes while it is <= tau + slack2 (rounded up) and
// finite (NaN fails)
template <class List>
__device__ __forceinline__ bool fine_passes(const List& best, float slack2,
                                            float key) {
  return key <= __fadd_ru(best.bound(), slack2) && key < INFINITY;
}

// a passing leaf child c (box key kb) into the list by its fine distance
// d, strict d < tau, the entry 2 pos + [d < kb]; the k-th entry it evicts,
// or d when it is not admitted, into `lost` (fminf drops NaN), and into
// `lost_anom` for an anomalous leaf
template <class Walk, class List>
__device__ __forceinline__ void fine_offer(Walk& walk, int leaf0, int k,
                                           float slack2, int c, float kb,
                                           int link, List& best, float& lost,
                                           float& lost_anom) {
  if (!fine_passes(best, slack2, kb)) return;
  const int pos = c - leaf0;
  const float d = walk.leaf(pos, link, kb);
  const bool anom = d < kb;
  if (best.admits_strict(d)) {
    // the k-th entry leaves ((inf, -1) while the list is not full)
    const float ed = best.bound();
    lost = fminf(lost, ed);
    if (best.bound_pos() & 1) lost_anom = fminf(lost_anom, ed);
    best.insert(d, 2 * pos + (anom ? 1 : 0), k);
  } else {
    lost = fminf(lost, d);
    if (anom) lost_anom = fminf(lost_anom, d);
  }
}

// the nearest-first walk with the fine distance as the list key (the
// note). Leaves `best` finished (ascending; entries 2 pos + [d < kb]),
// `lost` the smallest d left out and `lost_anom` that of the anomalous
// leaves left out.
template <class Walk, class List>
__device__ __forceinline__ void fine_nearest_first(Walk& walk, int n, int k,
                                                   float slack2, List& best,
                                                   float& lost,
                                                   float& lost_anom) {
  best.init(k);
  lost = INFINITY;
  lost_anom = INFINITY;
  float st_d[knn::kStack];   // pending internal nodes: key, left child
  int st_link[knn::kStack];
  int top = 0;
  const int leaf0 = n - 1;
  auto passes = [&](float key) { return fine_passes(best, slack2, key); };

  int link, rope;
  bool go = passes(walk.key(0, link, rope));
  while (go) {
    // `link` is the left child of an internal node the walk enters, whose
    // rope is its right sibling; a leaf child is offered before the next
    // key overwrites its box (one rolled copy of the leaf test and insert)
    const int l = link;
    int r = l, c = l, link_l = 0, link_r = 0;
    float dl = 0.0f, dr = 0.0f;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      int lk, rp;
      const float d = walk.key(c, lk, rp);
      if (c >= leaf0) {
        fine_offer(walk, leaf0, k, slack2, c, d, lk, best, lost, lost_anom);
      }
      if (side == 0) {
        dl = d;
        link_l = lk;
        r = c = rp;
      } else {
        dr = d;
        link_r = lk;
      }
    }
    const bool go_l = l < leaf0 && passes(dl);
    const bool go_r = r < leaf0 && passes(dr);
    if (go_l && go_r) {
      const bool left_nearer = dl <= dr;
      st_d[top] = left_nearer ? dr : dl;
      st_link[top] = left_nearer ? link_r : link_l;
      ++top;
      link = left_nearer ? link_l : link_r;
    } else if (go_l || go_r) {
      link = go_l ? link_l : link_r;
    } else {
      go = false;
      while (top > 0) {
        --top;
        if (passes(st_d[top])) {   // tau has tightened since the push
          link = st_link[top];
          go = true;
          break;
        }
      }
    }
  }
  best.finish(k);
}

// the certificate of the note: true when the rope walk's list may differ
// (an anomalous leaf with d <= D and kb >= lost)
template <class Walk, class List>
__device__ __forceinline__ bool fine_flagged(Walk& walk, int n, int k,
                                             float slack2, const List& best,
                                             float lost, float lost_anom) {
  const float dk = best.bound();
  bool flag = lost_anom <= dk && lost_anom < INFINITY;
  const float delta = 0.5f * slack2;
  auto check = [&](int j) {
    const int code = best.pos(j);
    if (code >= 0 && (code & 1) && __fadd_ru(best.dist(j), delta) >= lost) {
      int link, rope;
      flag |= walk.key(n - 1 + (code >> 1), link, rope) >= lost;
    }
  };
  if constexpr (List::kInRegisters) {
#pragma unroll
    for (int j = 0; j < List::kSlots; ++j) {
      if (j < k) check(j);
    }
  } else {
    for (int j = 0; j < k; ++j) check(j);
  }
  return flag;
}

// the tie pass when a leaf at the k-th distance dk was left out (lost ==
// dk: a rope walk over the nodes keyed <= dk in position order, the first
// k leaves with kb <= dk and d <= dk, the last k - below of those at dk
// kept), then put(j, d, sorted position or -1) for each slot j < k: the
// list's entries below dk, then the kept leaves at dk, highest position
// first
template <class Walk, class List, class Put>
__device__ __forceinline__ void fine_tie_pass_and_put(Walk& walk, int n,
                                                      int k, const List& best,
                                                      float lost, Put put) {
  const int leaf0 = n - 1;
  const float dk = best.bound();
  int below = k;
  int ties = 0;
  int ring[List::kSlots];
  if (lost == dk && dk != INFINITY) {
    below = 0;
    if constexpr (List::kInRegisters) {
#pragma unroll
      for (int j = 0; j < List::kSlots; ++j) {
        below += j < k && best.dist(j) < dk ? 1 : 0;
      }
    } else {
      for (int j = 0; j < k; ++j) below += best.dist(j) < dk ? 1 : 0;
    }
    const int m = k - below;   // >= 1: the k-th entry is at dk
    int seen = 0;
    int node = 0;
    while (node != -1 && seen < k) {
      int lk, rp;
      const float kb = walk.key(node, lk, rp);
      if (!(kb <= dk)) {
        node = rp;
      } else if (node < leaf0) {
        node = lk;
      } else {
        const float d = walk.leaf(node - leaf0, lk, kb);
        if (d <= dk) {
          ++seen;
          if (d == dk) ring[ties++ % m] = node - leaf0;
        }
        node = rp;
      }
    }
  }
  auto slot = [&](int j) {
    if (j < below) {
      put(j, best.dist(j), best.pos(j) >> 1);   // -1 stays -1
    } else {
      put(j, dk, ring[(ties - 1 - (j - below)) % (k - below)]);
    }
  };
  if constexpr (List::kInRegisters) {
#pragma unroll
    for (int j = 0; j < List::kSlots; ++j) {
      if (j < k) slot(j);
    }
  } else {
    for (int j = 0; j < k; ++j) slot(j);
  }
}

struct Query {
  const float *q_lo, *q_hi, *center, *radius;
};

// the walk of the note, one thread a query; a flagged query's index goes
// to flagged[1 + atomicAdd(flagged, 1)] and its row is left to
// fine_rope_kernel
template <class Nodes, class List>
__global__ void __launch_bounds__(kThreads)
    fine_nf_kernel(Nodes nodes, Values vals, const int* __restrict__ perm,
                   int n, int dim, Query qs, const float* __restrict__ rneg,
                   int q, int k, float* __restrict__ dists,
                   int* __restrict__ idxs, int* __restrict__ flagged) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  FineWalk<Nodes> walk{nodes, vals, dim, qs.radius,
                       qs.radius == nullptr ? 0.0f : __ldg(qs.radius + qi)};
  walk.load_query(qs.q_lo, qs.q_hi, qs.center, qi);
  const float slack2 = __fmul_ru(2.0f, walk.slack(rneg));
  List best;
  float lost, lost_anom;
  fine_nearest_first(walk, n, k, slack2, best, lost, lost_anom);
  if (fine_flagged(walk, n, k, slack2, best, lost, lost_anom)) {
    flagged[1 + atomicAdd(flagged, 1)] = qi;
    return;
  }
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  fine_tie_pass_and_put(walk, n, k, best, lost, [&](int j, float d, int p) {
    od[j] = d;
    oi[j] = p < 0 ? -1 : __ldg(perm + p);
  });
}

// the rope walk of the twin (rope_knn.cuh), one thread a query: the
// flagged queries of fine_nf_kernel (thread i walks flagged[1 + i], i <
// flagged[0]), or every query where `flagged` is null
template <class Nodes, class List>
__global__ void __launch_bounds__(kThreads)
    fine_rope_kernel(Nodes nodes, Values vals, const int* __restrict__ perm,
                     int n, int dim, Query qs, int q, int k,
                     float* __restrict__ dists, int* __restrict__ idxs,
                     const int* __restrict__ flagged) {
  int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (flagged != nullptr) {
    if (qi >= *flagged) return;
    qi = flagged[1 + qi];
  } else if (qi >= q) {
    return;
  }
  FineWalk<Nodes> walk{nodes, vals, dim, qs.radius,
                       qs.radius == nullptr ? 0.0f : __ldg(qs.radius + qi)};
  walk.load_query(qs.q_lo, qs.q_hi, qs.center, qi);
  List best;
  knn::rope_walk(walk, n, k, best);
  knn::put_list(best, k, perm, dists + static_cast<long long>(qi) * k,
                idxs + static_cast<long long>(qi) * k);
}

struct Call {
  const int* perm;
  int n, dim;
  Query qs;
  const float* rneg;
  int q, k;
  float* dists;
  int* idxs;
  int* flagged;   // null: the rope walk over every query
  cudaStream_t stream;
};

template <class Nodes>
cudaError_t launch_k(const Nodes& nodes, const Values& vals, const Call& c) {
  return knn::with_list<kMaxK>(c.k, [&](auto tag) {
    using List = typename decltype(tag)::type;
    const int blocks = (c.q + kThreads - 1) / kThreads;
    if (c.flagged != nullptr) {
      fine_nf_kernel<Nodes, List><<<blocks, kThreads, 0, c.stream>>>(
          nodes, vals, c.perm, c.n, c.dim, c.qs, c.rneg, c.q, c.k, c.dists,
          c.idxs, c.flagged);
    }
    fine_rope_kernel<Nodes, List><<<blocks, kThreads, 0, c.stream>>>(
        nodes, vals, c.perm, c.n, c.dim, c.qs, c.q, c.k, c.dists, c.idxs,
        c.flagged);
  });
}

// the arguments both entries share, checked; `vals` / `nodes` built
cudaError_t dispatch(const void* node_lo, const void* node_hi,
                     const void* rope, const void* left, const void* records,
                     const void* vrec, const void* val_a, const void* val_b,
                     const void* val_c, const void* val_r, int n, int dim,
                     int val_kind, int k, const Call& c) {
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
    return cudaErrorInvalidValue;
  }
  const int stride = val_kind == kTriangles ? 3 : val_kind == kSegments ? 2
                                                                        : 1;
  const Values vals{records != nullptr ? static_cast<const int4*>(vrec)
                                       : nullptr,
                    static_cast<const float*>(val_a),
                    static_cast<const float*>(val_b),
                    static_cast<const float*>(val_c),
                    static_cast<const float*>(val_r), stride, dim, val_kind};
  if (records != nullptr) {
    return launch_k(Records3{{static_cast<const int4*>(records)}}, vals, c);
  }
  const Flat nodes{{static_cast<const float*>(node_lo),
                    static_cast<const float*>(node_hi),
                    static_cast<const int*>(rope),
                    static_cast<const int*>(left), c.perm, n}};
  return launch_k(nodes, vals, c);
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
// radius: a Spheres query's radii (q,), else null. rneg: Spheres values'
// max(0, -min radius) (one float on the device), else null. flagged: (q +
// 1,) int32 scratch; the count of the queries the rope walk re-walks is
// left in flagged[0].
REPRO_EXPORT int fine_knn_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* perm, const void* records,
    const void* vrec, const void* val_a, const void* val_b,
    const void* val_c, const void* val_r, const void* q_lo, const void* q_hi,
    const void* center, const void* radius, const void* rneg, int n, int q,
    int dim, int val_kind, int k, void* dists, void* idxs, void* flagged,
    void* stream) {
  if (flagged == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Call c{static_cast<const int*>(perm), n, dim,
               {static_cast<const float*>(q_lo),
                static_cast<const float*>(q_hi),
                static_cast<const float*>(center),
                static_cast<const float*>(radius)},
               static_cast<const float*>(rneg), q, k,
               static_cast<float*>(dists), static_cast<int*>(idxs),
               static_cast<int*>(flagged), static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      cudaMemsetAsync(flagged, 0, sizeof(int), c.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch(node_lo, node_hi, rope, left, records,
                                   vrec, val_a, val_b, val_c, val_r, n, dim,
                                   val_kind, k, c));
}

// the rope walk alone over every query (fine_rope_kernel): the exact
// order the nearest-first walk is held to on the card. The arguments of
// fine_knn_launch without rneg and flagged.
REPRO_EXPORT int fine_knn_rope_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* perm, const void* records,
    const void* vrec, const void* val_a, const void* val_b,
    const void* val_c, const void* val_r, const void* q_lo, const void* q_hi,
    const void* center, const void* radius, int n, int q, int dim,
    int val_kind, int k, void* dists, void* idxs, void* stream) {
  const Call c{static_cast<const int*>(perm), n, dim,
               {static_cast<const float*>(q_lo),
                static_cast<const float*>(q_hi),
                static_cast<const float*>(center),
                static_cast<const float*>(radius)},
               nullptr, q, k, static_cast<float*>(dists),
               static_cast<int*>(idxs), nullptr,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(node_lo, node_hi, rope, left, records,
                                   vrec, val_a, val_b, val_c, val_r, n, dim,
                                   val_kind, k, c));
}
