// The first k hits along each ray: the k-nearest walk with the ray
// parameter t as its key (RayNearest, cast_nearest).
//
// Replaces: the reference's RayNearest path, src/repro/core/engine.py::
//   exec_ray_nearest, which compiles core/traversal.py::traverse_knn into
//   one lax.while_loop program on the device (no pl.pallas_call of its
//   own). Its rope walk: at a node, the key is the slab-entry t of the
//   node box (geometry.ray_box, clamped to >= 0; +inf on a miss); descend
//   to the left child while the key is strictly below the running k-th
//   best t (tau), else escape by the rope; at a leaf, admit the value when
//   its box key and its hit t (predicates.leaf_distance with fused=True:
//   the slab for Points and Boxes, ray_sphere in the "walk" order for
//   Spheres, the fused Moller-Trumbore for 3-D Triangles) are both below
//   tau, placed before the equal entries.
// Bound on this card: the callback kernel's ray walk, a pointer chase
//   over the tree's node records (about 75 MB at 2^20 leaves, above the
//   50 MB L2) at data-dependent addresses, pruned by t once k hits are
//   held: latency-bound, a node record pair and a few dozen float
//   operations per visit.
// Design: one thread walks one ray. Over Spheres and 3-D Triangles, and
//   in dims other than 3, the thread walks the twin's node sequence with
//   the twin's running k-th best (knn_list.cuh: KeyList in registers up
//   to k = 32, KeyHeap in local memory up to KNN_MAX_K = 256). The list
//   orders entries by (t, sorted-leaf position descending): the walk
//   reaches leaves in ascending position, so that key places a new leaf
//   before the equal entries, as the twin's insert does, and the lists
//   equal the twin's bit for bit, ties and the (inf, -1) padding
//   included, by construction.
//   Over Points and Boxes values in 3-D (ray_knn_nf_kernel) it walks
//   nearest first with a stack: knn_walk.cuh's walk, shared with
//   bvh_traverse.cu's point kNN, with the slab-entry t as the key, its
//   stack bound (96 entries) and its tie pass, which keeps the twin's
//   leaves at the k-th t: ties at t = 0 are
//   the rule where an origin lies inside several boxes (ray_slab clamps
//   the entry t). That walk is exact because a node's key never exceeds
//   that of a leaf below it: the slab test is monotone under rounding for
//   nested boxes, and a Points or Boxes leaf's hit is the slab test of
//   the leaf's own box, its key. For Spheres and Triangles that premise
//   fails: the computed hit t can round below the slab-entry t of the
//   leaf's own box (the hit point lies in the box only in exact
//   arithmetic), the twin admits a leaf only when both its box key and
//   its hit t are below tau at its visit, and so which such leaves it
//   keeps depends on its visit order, including leaves in subtrees a
//   nearest-first walk would prune unseen (scripts/ray_variants.py times
//   both walks).
//   In 3-D the walks read LBVH.records (two 16-byte records a node,
//   (lo.xyz, rope) and (hi.xyz, left child | leaf_perm)) and, for Spheres
//   and Triangles values, the 16-byte value records of ray_tests.cuh in
//   sorted-leaf order, with no leaf_perm gather; a Points or Boxes leaf's
//   hit is the node test at the leaf. Other dims (1..16, no triangles)
//   read the flat node arrays and gather a sphere through leaf_perm.
//   Thread i walks ray i.
#include "common.cuh"
#include "knn_list.cuh"
#include "knn_walk.cuh"
#include "ray_tests.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 256;   // rays per block
constexpr int kMaxK = 256;      // the largest k (KNN_MAX_K)
enum Kind { kPoints = 0, kBoxes = 1, kSpheres = 2, kTriangles = 3 };

// 3-D node records: node m is rec[2m] = (lo.xyz, rope) and rec[2m + 1] =
// (hi.xyz, left child of an internal node | leaf_perm of a leaf)
struct Records3 {
  using Ray = Ray3;
  const int4* __restrict__ rec;

  // node m's slab-entry t (+inf on a miss); its link and rope
  __device__ __forceinline__ float key(const RayReg<3>& ray, int m, int,
                                       int& link, int& rope) const {
    const int4 a = __ldg(rec + 2 * static_cast<long long>(m));
    const int4 b = __ldg(rec + 2 * static_cast<long long>(m) + 1);
    float lo[3], hi[3];
    xyz_of(a, lo);
    xyz_of(b, hi);
    float t;
    const bool hit = ray_slab(ray.o, ray.inv, ray.zero, lo, hi, 3,
                              LoadPlain(), t);
    link = b.w;
    rope = a.w;
    return hit ? t : INFINITY;
  }
};

// any dim up to kMaxDim: the flat arrays
struct Flat {
  using Ray = RayReg<kMaxDim>;
  const float* __restrict__ lo;     // (2n-1, dim)
  const float* __restrict__ hi;     // (2n-1, dim)
  const int* __restrict__ rope;     // (2n-1,)
  const int* __restrict__ left;     // (n-1,)
  const int* __restrict__ perm;     // (n,)
  int n;

  __device__ __forceinline__ float key(const RayReg<kMaxDim>& ray, int m,
                                       int dim, int& link, int& rp) const {
    float t;
    const bool hit = ray_slab(ray.o, ray.inv, ray.zero,
                              lo + static_cast<long long>(m) * dim,
                              hi + static_cast<long long>(m) * dim, dim,
                              LoadLdg(), t);
    link = m < n - 1 ? __ldg(left + m) : __ldg(perm + (m - (n - 1)));
    rp = __ldg(rope + m);
    return hit ? t : INFINITY;
  }
};

// leaf tests: the hit t of leaf `pos` (original index `orig`), given the
// node test's key `kb` of the leaf's own box

struct LeafSphere3 {
  const int4* __restrict__ vrec;
  __device__ __forceinline__ float hit_t(const Ray3& ray, int pos, int,
                                         float, int) const {
    float t;
    return sphere_record_hit(ray, vrec, pos, t) ? t : INFINITY;
  }
};

struct LeafTriangle3 {
  const int4* __restrict__ vrec;
  __device__ __forceinline__ float hit_t(const Ray3& ray, int pos, int,
                                         float, int) const {
    float t;
    return triangle_record_hit(ray, vrec, pos, t) ? t : INFINITY;
  }
};

// any dim: Points and Boxes from the node test, Spheres gathered by the
// original index (kind is uniform across the launch)
struct LeafFlat {
  const float* __restrict__ center;   // (n, dim) of Spheres values
  const float* __restrict__ radius;   // (n,)
  int kind;
  __device__ __forceinline__ float hit_t(const RayReg<kMaxDim>& ray, int,
                                         int orig, float kb, int dim) const {
    if (kind != kSpheres) return kb;
    const float* cen = center + static_cast<long long>(orig) * dim;
    float t;
    return ray_sphere(ray.o, [&](int c) { return __ldg(ray.dir + c); },
                      [&](int c) { return __ldg(cen + c); },
                      __ldg(radius + orig), dim, t)
               ? t : INFINITY;
  }
};

template <class Nodes, class Leaf, class List>
__global__ void __launch_bounds__(kThreads)
    ray_knn_kernel(Nodes nodes, Leaf leaf, const int* __restrict__ perm,
                   int n, int dim, const float* __restrict__ origin,
                   const float* __restrict__ direction, int q, int k,
                   float* __restrict__ ts, int* __restrict__ idxs) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  typename Nodes::Ray ray;
  ray.load(origin + static_cast<long long>(qi) * dim,
           direction + static_cast<long long>(qi) * dim, dim);
  List best;
  best.init(k);
  const int leaf0 = n - 1;   // node id of sorted-leaf position 0

  int node = 0;
  while (node != -1) {
    int link, rope;
    const float kb = nodes.key(ray, node, dim, link, rope);
    const bool promising = best.admits_strict(kb);
    if (node < leaf0) {
      node = promising ? link : rope;
      continue;
    }
    if (promising) {
      const int pos = node - leaf0;
      const float t = leaf.hit_t(ray, pos, link, kb, dim);
      // ascending positions: the key (t, position descending) places the
      // leaf before the equal entries
      if (best.admits_strict(t)) best.insert(t, pos, k);
    }
    node = rope;
  }
  best.finish(k);

  float* ot = ts + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  if constexpr (List::kInRegisters) {
#pragma unroll
    for (int j = 0; j < List::kSlots; ++j) {
      if (j < k) {
        const int p = best.pos(j);
        ot[j] = best.dist(j);
        oi[j] = p < 0 ? -1 : __ldg(perm + p);
      }
    }
  } else {
    for (int j = 0; j < k; ++j) {
      const int p = best.pos(j);
      ot[j] = best.dist(j);
      oi[j] = p < 0 ? -1 : __ldg(perm + p);
    }
  }
}

// ---------------------------------------------------------------------------
// Points and Boxes values in 3-D: nearest first with a stack
// ---------------------------------------------------------------------------

// a ray's keys for the walk of knn_walk.cuh: node slab-entry t
struct RayKeys {
  const Records3& nodes;
  const RayReg<3>& ray;
  __device__ __forceinline__ float key(int m, int& link, int& rope) const {
    return nodes.key(ray, m, 3, link, rope);
  }
};

template <class List>
__global__ void __launch_bounds__(kThreads)
    ray_knn_nf_kernel(Records3 nodes, const int* __restrict__ perm, int n,
                      const float* __restrict__ origin,
                      const float* __restrict__ direction, int q, int k,
                      float* __restrict__ ts, int* __restrict__ idxs) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  RayReg<3> ray;
  ray.load(origin + 3LL * qi, direction + 3LL * qi, 3);
  const RayKeys keys{nodes, ray};
  List best;
  float lost;   // the smallest t left out (leaf or node)
  knn::nearest_first(keys, n, k, best, lost);
  // the tie pass takes the twin's leaves at the k-th t: t = 0 ties are
  // the rule where the origin lies inside several boxes
  float* ot = ts + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  knn::tie_pass_and_put(keys, n, k, best, lost, [&](int j, float t, int p) {
    ot[j] = t;
    oi[j] = p < 0 ? -1 : __ldg(perm + p);
  });
}

struct Call {
  const int* perm;
  int n, dim;
  const float* origin;
  const float* direction;
  int q, k;
  float* ts;
  int* idxs;
  cudaStream_t stream;
};

template <class Nodes, class Leaf, class List>
void launch(const Nodes& nodes, const Leaf& leaf, const Call& c) {
  const int blocks = (c.q + kThreads - 1) / kThreads;
  ray_knn_kernel<Nodes, Leaf, List><<<blocks, kThreads, 0, c.stream>>>(
      nodes, leaf, c.perm, c.n, c.dim, c.origin, c.direction, c.q, c.k, c.ts,
      c.idxs);
}

template <class List>
void launch_nf(const Records3& nodes, const Call& c) {
  const int blocks = (c.q + kThreads - 1) / kThreads;
  ray_knn_nf_kernel<List><<<blocks, kThreads, 0, c.stream>>>(
      nodes, c.perm, c.n, c.origin, c.direction, c.q, c.k, c.ts, c.idxs);
}

cudaError_t launch_nf_k(const Records3& nodes, const Call& c) {
  using knn::KeyHeap;
  using knn::KeyList;
  if (c.k <= 1) launch_nf<KeyList<1, true>>(nodes, c);
  else if (c.k <= 4) launch_nf<KeyList<4, true>>(nodes, c);
  else if (c.k <= 8) launch_nf<KeyList<8, true>>(nodes, c);
  else if (c.k <= 16) launch_nf<KeyList<16, true>>(nodes, c);
  else if (c.k <= 32) launch_nf<KeyList<32, true>>(nodes, c);
  else if (c.k <= kMaxK) launch_nf<KeyHeap<kMaxK, true>>(nodes, c);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <class Nodes, class Leaf>
cudaError_t launch_k(const Nodes& nodes, const Leaf& leaf, const Call& c) {
  using knn::KeyHeap;
  using knn::KeyList;
  if (c.k <= 1) launch<Nodes, Leaf, KeyList<1, true>>(nodes, leaf, c);
  else if (c.k <= 4) launch<Nodes, Leaf, KeyList<4, true>>(nodes, leaf, c);
  else if (c.k <= 8) launch<Nodes, Leaf, KeyList<8, true>>(nodes, leaf, c);
  else if (c.k <= 16) launch<Nodes, Leaf, KeyList<16, true>>(nodes, leaf, c);
  else if (c.k <= 32) launch<Nodes, Leaf, KeyList<32, true>>(nodes, leaf, c);
  else if (c.k <= kMaxK) launch<Nodes, Leaf, KeyHeap<kMaxK, true>>(nodes, leaf, c);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// ts / idxs: (q, k) float32 / int32 outputs. records: the (2n-1, 8) int32
// node records of a 3-D tree (LBVH.records), or null for the flat arrays
// (node_lo ... perm); vrec: the value records of Spheres or Triangles
// values in 3-D (pack_values), else null; center / radius: Spheres values
// for the flat arrays. val_kind: Points, Boxes, Spheres or Triangles
// (3-D, records only).
REPRO_EXPORT int ray_knn_launch(const void* node_lo, const void* node_hi,
                                const void* rope, const void* left,
                                const void* perm, const void* records,
                                const void* vrec, const void* center,
                                const void* radius, const void* origin,
                                const void* direction, int n, int q, int dim,
                                int val_kind, int k,
                                void* ts, void* idxs, void* stream) {
  const bool packed = val_kind == kSpheres || val_kind == kTriangles;
  if (dim < 1 || dim > kMaxDim || k < 1 || k > kMaxK || n < 2 ||
      val_kind < kPoints || val_kind > kTriangles ||
      (records != nullptr && dim != 3) ||
      (val_kind == kTriangles && records == nullptr) ||
      (records != nullptr && packed && vrec == nullptr) ||
      (records == nullptr && val_kind == kSpheres &&
       (center == nullptr || radius == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Call c{static_cast<const int*>(perm), n, dim,
         static_cast<const float*>(origin),
         static_cast<const float*>(direction), q, k, static_cast<float*>(ts),
         static_cast<int*>(idxs), static_cast<cudaStream_t>(stream)};
  if (records != nullptr) {
    const Records3 nodes{static_cast<const int4*>(records)};
    const auto v = static_cast<const int4*>(vrec);
    if (val_kind == kSpheres) {
      return static_cast<int>(launch_k(nodes, LeafSphere3{v}, c));
    }
    if (val_kind == kTriangles) {
      return static_cast<int>(launch_k(nodes, LeafTriangle3{v}, c));
    }
    return static_cast<int>(launch_nf_k(nodes, c));
  }
  const Flat nodes{static_cast<const float*>(node_lo),
                   static_cast<const float*>(node_hi),
                   static_cast<const int*>(rope), static_cast<const int*>(left),
                   static_cast<const int*>(perm), n};
  return static_cast<int>(launch_k(
      nodes, LeafFlat{static_cast<const float*>(center),
                      static_cast<const float*>(radius), val_kind},
      c));
}
