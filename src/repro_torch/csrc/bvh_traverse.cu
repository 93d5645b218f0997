// BVH traversal: the stackless rope walk of the spatial queries (count +
// fill), and a nearest-first walk with a stack for k-nearest, with an
// instance for k-nearest outside the query's label (Nearest.exclude).
//
// Replaces: src/repro/kernels/bvh_traverse.py::bvh_traverse_spatial (body
//   _spatial_kernel) and ::bvh_traverse_knn (body _knn_kernel). The TPU
//   kernels advanced a block of rope-walk cursors in lockstep until all
//   were -1 (at a node: test the query against the node box, then move to
//   left_child (descend) or rope (skip); rope -1 ends the walk).
// Spatial: every cursor's walk is independent, so one thread per query
//   running its own loop visits the same node sequence as the twin.
//   Bound on this card: per visited node one node box (2 * dim floats)
//   and two or three int32s at a data-dependent address and about 6 * dim
//   float operations: a latency-bound pointer chase over a tree (about
//   75 MB at 2^20 leaves) larger than the 50 MB L2. So the 3-D instance
//   (spatial_kernel3) cuts the loads per visit, as callback_kernel3 of
//   bvh_callback.cu does for the same walk:
//   * node m is two 16-byte records of LBVH.records, (lo.xyz, rope) and
//     (hi.xyz, left child | leaf_perm), one vector load each;
//   * range_last is read at an internal node only under a pair filter
//     (min_pos >= 0): range_last >= 0 everywhere, so a negative min_pos
//     passes every node; at a leaf range_last is the leaf's position, so
//     the filter is pos > min_pos with no read;
//   * a leaf's box is its value's box, so the d2 of the node test at the
//     leaf is the leaf test (d2 <= r2, and sqrtf(d2) <= r under fine_sqrt),
//     and the record's .w is the leaf's original index;
//   * thread i walks query order[i] where the wrapper gives an order,
//     and writes only that query's row; it pads its row with -1 itself.
//   The node test stays the twin's unified d2 form (not callback_kernel3's
//   interval overlap, which differs where a square underflows), so the
//   two walks keep their own instances. Other dims (1..16) run
//   spatial_kernel over the flat arrays.
// k-nearest: the rope walk descends left first with the running k-th best
//   (tau) at +inf, so its first k leaves are the tree's leftmost, far from
//   most queries, and tau stays loose until the walk reaches the query's
//   own region: 8,842 node visits per query at N = 2^20, k = 10 (125 for
//   a spatial walk of ~10 neighbours). The bound is the same pointer
//   chase, paid per visit, so the design cuts visits:
//   * nearest first (ArborX's own kNN traversal): at an internal node both
//     children's boxes are tested; the walk goes on to the nearer
//     promising one and pushes the farther promising one with its d2; a
//     popped node is tested again against the tightened tau. A leaf child
//     is offered to the list at once.
//   * the twin's list, exactly: the rope walk reaches leaves in ascending
//     sorted-leaf position, admits a leaf only when d2 < tau (strict) and
//     places it before the equal entries. So its list is every leaf with
//     d2 below D, the k-th smallest d2, ordered by (d2 ascending, position
//     descending), then, of the leaves at D, the m = k - #{d2 < D} with
//     the highest positions among the first k leaves with d2 <= D in
//     position order (it takes the leaves at D that come before its list
//     holds k entries <= D, and each later nearer leaf evicts the lowest
//     of them): not a fixed order on (d2, position), since which leaves
//     at D stay depends on where the nearer ones lie. The new walk admits
//     and prunes as strictly as the twin (d2 < tau), which in any visit
//     order keeps every leaf below D and finds D itself, and places each
//     insert by the key (d2, position descending) (knn_list.cuh,
//     kLaterFirst). It notes the smallest d2 of all it leaves out (a
//     rejected or evicted leaf, a pruned node): when that is not D, no
//     leaf at D was left out and the list is the twin's. When it is D (an
//     exact tie at the k-th distance, or a pruned box exactly at it), a
//     tie pass, a rope walk over the nodes with d2 <= D in position
//     order, takes the first k leaves with d2 <= D and fills the slots
//     from #{d2 < D} on with the last m of them at D, highest position
//     first. A node's d2 never exceeds that of a leaf below it
//     (subtraction, max and FMA on non-negative values are monotone under
//     rounding), so the pruning is exact; a NaN d2 prunes its subtree in
//     both walks.
//   * the stack needs no overflow path: the tree splits on the 96-bit key
//     (hi | lo | sorted index) of karras.cu, whose keys are distinct, and
//     each internal node's common prefix is strictly longer than its
//     parent's (the split is where the prefix's next bit turns from 0 to
//     1), so an internal node at depth d has a prefix of at least d bits,
//     and a prefix of distinct 96-bit keys is at most 95 bits: internal
//     nodes lie at depths 0..95. The stack holds internal nodes only, at
//     strictly increasing depths 1..95 from bottom to top (a push is one
//     level below the current node; a pop returns to that level), so 95
//     entries; kStack = 96 in knn_walk.cuh, which holds the walk and
//     its tie pass for this kernel and for ray_knn.cu's walk over Points
//     and Boxes.
//   * in 3-D (knn_kernel<Records3, ...>) each node is two 16-byte records
//     of LBVH.records, (lo.xyz, rope) and (hi.xyz, left child | leaf_perm),
//     one vector load each; a node's right child is its left child's rope
//     (a left child's escape pointer is its right sibling), so both
//     children come from the left child's link and two record reads each.
//     Other dims (1..16) read node_lo / node_hi / rope / left_child.
//   * thread i walks query order[i] where the wrapper gives an order (the
//     tree's leaf order when the queries are the indexed points), so a
//     warp walks neighbouring queries through the same nodes.
//   The list is KeyList<K> in registers for k <= 32, KeyHeap<256> in
//   local memory for 33..256; the stack (8 bytes an entry) is in local
//   memory.
// k-nearest outside the query's label (knn_exclude_kernel, Nearest.exclude):
//   replaces no TPU kernel. The reference pins Nearest.exclude to its loop
//   walk (src/repro/core/bvh.py::_knn_impl -> traversal.py::traverse_knn with
//   exclude_labels / leaf_labels, the leaf test at :174), which jax.jit
//   compiles into one device program with no pallas_call. Borůvka's EMST
//   runs one such query over all N points in every round (up to log2 N
//   rounds), so here it is a kernel: the nearest-first walk and tie pass
//   above (knn_walk.cuh) with another key, ExcludeKeys:
//   * the loop walk compares fine distances, sqrt of the fused d2, not d2;
//     two distinct d2 can round to one distance, so a d2 key would order
//     such ties otherwise. The key is sqrtf(d2) (correctly rounded: the
//     library is built without --use_fast_math);
//   * it is +inf for a leaf whose label is the query's (the loop walk never
//     admits it), and for an internal node whose leaves all carry the
//     query's label (node_labels in kernels/bvh_traverse.py: one label or
//     MIXED per node, from the leaf labels' change counts at the node's
//     range ends): no leaf below it is a candidate, so pruning it changes
//     no list, and in the last rounds, where a component holds about N / 2
//     points, it keeps a query from walking its own component's subtrees.
//     A node labelled MIXED (-1) is never pruned, so a label of -1 is
//     excluded leaf by leaf;
//   * sqrt is monotone, so a node's key still never exceeds that of a leaf
//     below it (an excluded leaf's +inf exceeds everything), and a
//     candidate leaf's key is its fine distance: the two properties the
//     argument for knn_walk.cuh needs, so the kernel's lists are the rope
//     walk's (the twin's, and the reference's) bit for bit, ties included.
//     An excluded leaf keyed +inf is never admitted (inf < tau is false),
//     never lowers `lost`, and the tie pass, which runs only at a finite
//     k-th key, never counts it.
//   Bound: the same pointer chase as the k-nearest walk, plus one 4-byte
//   label a visited node. Points queries over Points or Boxes values,
//   dims 1..16 (node records in 3-D), k <= 256.
// Both walks compute a box's squared distance as g0*g0, then one explicit
//   fmaf per further dimension (the order XLA:CPU gives the reference
//   kernels, and geometry.sum_sq_fused's); the library is built with
//   --fmad=false so no other product is contracted: the leaf tests equal
//   the twins' bit for bit.
#include "common.cuh"
#include "knn_list.cuh"
#include "knn_walk.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 256;   // queries per block
constexpr int kMaxK = 256;      // the largest k (KNN_MAX_K)

struct Tree {
  const float* __restrict__ lo;     // (2n-1, dim)
  const float* __restrict__ hi;     // (2n-1, dim)
  const int* __restrict__ rope;     // (2n-1,)
  const int* __restrict__ left;     // (n-1,)
  const int* __restrict__ perm;     // (n,)
  int n;
  int dim;
};

// ---------------------------------------------------------------------------
// spatial
// ---------------------------------------------------------------------------

template <bool kFineSqrt>
__global__ void spatial_kernel(Tree t, const int* __restrict__ range_last,
                               const float* __restrict__ qlo,
                               const float* __restrict__ qhi,
                               const float* __restrict__ radius,
                               const int* __restrict__ min_pos, int q, int cap,
                               int* __restrict__ counts,
                               int* __restrict__ buf) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int dim = t.dim;
  float ql[kMaxDim], qh[kMaxDim];
#pragma unroll
  for (int c = 0; c < kMaxDim; ++c) {
    if (c < dim) {
      ql[c] = qlo[static_cast<long long>(qi) * dim + c];
      qh[c] = qhi[static_cast<long long>(qi) * dim + c];
    }
  }
  const float r = radius[qi];
  const float r2 = r * r;
  const int mp = min_pos == nullptr ? -1 : min_pos[qi];
  int* out = buf + static_cast<long long>(qi) * cap;

  int cnt = 0;
  int node = 0;
  while (node != -1) {
    const float* lo = t.lo + static_cast<long long>(node) * dim;
    const float* hi = t.hi + static_cast<long long>(node) * dim;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxDim; ++c) {
      if (c < dim) {
        const float g = max_nan(max_nan(ql[c] - __ldg(hi + c),
                                        __ldg(lo + c) - qh[c]), 0.0f);
        d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
      }
    }
    const bool overlap = d2 <= r2 && __ldg(range_last + node) > mp;
    const bool is_leaf = node >= t.n - 1;
    if (is_leaf) {
      if (overlap && (!kFineSqrt || sqrtf(d2) <= r)) {
        if (cnt < cap) out[cnt] = __ldg(t.perm + (node - (t.n - 1)));
        ++cnt;
      }
      node = __ldg(t.rope + node);
    } else {
      node = overlap ? __ldg(t.left + node) : __ldg(t.rope + node);
    }
  }
  counts[qi] = cnt;
  for (int j = cnt; j < cap; ++j) out[j] = -1;
}

// the 3-D instance over node records: rec[2m] = (lo.xyz, rope), rec[2m + 1]
// = (hi.xyz, left child of an internal node | leaf_perm of a leaf)
template <bool kFineSqrt>
__global__ void __launch_bounds__(kThreads)
    spatial_kernel3(const int4* __restrict__ rec,
                    const int* __restrict__ range_last, int n,
                    const float* __restrict__ qlo,
                    const float* __restrict__ qhi,
                    const float* __restrict__ radius,
                    const int* __restrict__ min_pos,
                    const int* __restrict__ order, int q, int cap,
                    int* __restrict__ counts, int* __restrict__ buf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int qi = order == nullptr ? i : __ldg(order + i);
  const long long qo = static_cast<long long>(qi) * 3;
  float ql[3], qh[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ql[c] = __ldg(qlo + qo + c);
    qh[c] = __ldg(qhi + qo + c);
  }
  const float r = __ldg(radius + qi);
  const float r2 = r * r;
  const int mp = min_pos == nullptr ? -1 : __ldg(min_pos + qi);
  int* out = buf + static_cast<long long>(qi) * cap;
  const int n1 = n - 1;

  int cnt = 0;
  int node = 0;
  while (node != -1) {
    const int4 a = __ldg(rec + 2 * static_cast<long long>(node));
    const int4 b = __ldg(rec + 2 * static_cast<long long>(node) + 1);
    const float lo[3] = {__int_as_float(a.x), __int_as_float(a.y),
                         __int_as_float(a.z)};
    const float hi[3] = {__int_as_float(b.x), __int_as_float(b.y),
                         __int_as_float(b.z)};
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = max_nan(max_nan(ql[c] - hi[c], lo[c] - qh[c]), 0.0f);
      d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
    }
    const bool reach = d2 <= r2;
    if (node < n1) {
      node = reach && (mp < 0 || __ldg(range_last + node) > mp) ? b.w : a.w;
      continue;
    }
    if (reach && node - n1 > mp && (!kFineSqrt || sqrtf(d2) <= r)) {
      if (cnt < cap) out[cnt] = b.w;
      ++cnt;
    }
    node = a.w;
  }
  counts[qi] = cnt;
  for (int j = cnt; j < cap; ++j) out[j] = -1;
}

// ---------------------------------------------------------------------------
// k-nearest: nearest first, a stack, the list ordered by (d2, position)
// ---------------------------------------------------------------------------

// 3-D node records: node m is rec[2m] = (lo.xyz, rope) and rec[2m + 1] =
// (hi.xyz, left child of an internal node | leaf_perm of a leaf)
struct Records3 {
  static constexpr int kDims = 3;
  const int4* __restrict__ rec;

  // the query's squared distance to node m's box; its link (left child)
  // and rope
  __device__ __forceinline__ float test(const float (&qc)[3], int m, int dim,
                                        int& link, int& rope) const {
    const int4 a = __ldg(rec + 2 * static_cast<long long>(m));
    const int4 b = __ldg(rec + 2 * static_cast<long long>(m) + 1);
    const float lo[3] = {__int_as_float(a.x), __int_as_float(a.y),
                         __int_as_float(a.z)};
    const float hi[3] = {__int_as_float(b.x), __int_as_float(b.y),
                         __int_as_float(b.z)};
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = max_nan(max_nan(lo[c] - qc[c], qc[c] - hi[c]), 0.0f);
      d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
    }
    link = b.w;
    rope = a.w;
    return d2;
  }
};

// any dim up to kMaxDim: the flat arrays
struct Flat {
  static constexpr int kDims = kMaxDim;
  Tree t;

  __device__ __forceinline__ float test(const float (&qc)[kMaxDim], int m,
                                        int dim, int& link, int& rope) const {
    const float* lo = t.lo + static_cast<long long>(m) * dim;
    const float* hi = t.hi + static_cast<long long>(m) * dim;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxDim; ++c) {
      if (c < dim) {
        const float g = max_nan(max_nan(__ldg(lo + c) - qc[c],
                                        qc[c] - __ldg(hi + c)), 0.0f);
        d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
      }
    }
    link = m < t.n - 1 ? __ldg(t.left + m) : -1;
    rope = __ldg(t.rope + m);
    return d2;
  }
};

// the query's keys for the walk of knn_walk.cuh
template <class Nodes>
struct PointKeys {
  const Nodes& nodes;
  const float (&qc)[Nodes::kDims];
  int dim;
  __device__ __forceinline__ float key(int m, int& link, int& rope) const {
    return nodes.test(qc, m, dim, link, rope);
  }
};

template <class Nodes, class List>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(Nodes nodes, const int* __restrict__ perm, int n, int dim,
               const float* __restrict__ queries,
               const int* __restrict__ order, int q, int k,
               float* __restrict__ dists, int* __restrict__ idxs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int qi = order == nullptr ? i : __ldg(order + i);
  float qc[Nodes::kDims];
#pragma unroll
  for (int c = 0; c < Nodes::kDims; ++c) {
    if (c < dim) qc[c] = __ldg(queries + static_cast<long long>(qi) * dim + c);
  }
  const PointKeys<Nodes> keys{nodes, qc, dim};
  List best;
  float lost;   // the smallest d2 left out (leaf or node)
  knn::nearest_first(keys, n, k, best, lost);
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  knn::tie_pass_and_put(keys, n, k, best, lost, [&](int j, float d2, int p) {
    od[j] = sqrtf(d2);
    oi[j] = p < 0 ? -1 : __ldg(perm + p);
  });
}

// the exclusion walk's keys: sqrtf of the node test's d2, +inf where the
// node's label excludes it (the note at the top)
constexpr int kMixed = -1;   // node_labels' MIXED

template <class Nodes>
struct ExcludeKeys {
  const Nodes& nodes;
  const float (&qc)[Nodes::kDims];
  const int* __restrict__ labels;   // (2n-1,) node labels
  int label;                        // the query's
  int dim;
  int leaf0;                        // n - 1: the first leaf's node id
  __device__ __forceinline__ float key(int m, int& link, int& rope) const {
    const float d2 = nodes.test(qc, m, dim, link, rope);
    const int l = __ldg(labels + m);
    return l == label && (m >= leaf0 || l != kMixed) ? INFINITY : sqrtf(d2);
  }
};

template <class Nodes, class List>
__global__ void __launch_bounds__(kThreads)
    knn_exclude_kernel(Nodes nodes, const int* __restrict__ perm, int n,
                       int dim, const float* __restrict__ queries,
                       const int* __restrict__ order,
                       const int* __restrict__ labels,
                       const int* __restrict__ qlabels, int q, int k,
                       float* __restrict__ dists, int* __restrict__ idxs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int qi = order == nullptr ? i : __ldg(order + i);
  float qc[Nodes::kDims];
#pragma unroll
  for (int c = 0; c < Nodes::kDims; ++c) {
    if (c < dim) qc[c] = __ldg(queries + static_cast<long long>(qi) * dim + c);
  }
  const ExcludeKeys<Nodes> keys{nodes, qc, labels, __ldg(qlabels + qi), dim,
                                n - 1};
  List list;
  float lost;   // the smallest key left out (leaf or node)
  knn::nearest_first(keys, n, k, list, lost);
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  knn::tie_pass_and_put(keys, n, k, list, lost, [&](int j, float d, int p) {
    od[j] = d;
    oi[j] = p < 0 ? -1 : __ldg(perm + p);
  });
}

// the exclusion instance's node and query labels; null for the plain walk
struct Labels {
  const int* nodes = nullptr;
  const int* queries = nullptr;
};

template <class Nodes, class List>
void launch_knn(const Nodes& nodes, const int* perm, int n, int dim,
                const float* queries, const int* order, int q, int k,
                float* dists, int* idxs, Labels lab, cudaStream_t stream) {
  const int blocks = (q + kThreads - 1) / kThreads;
  if (lab.nodes == nullptr) {
    knn_kernel<Nodes, List><<<blocks, kThreads, 0, stream>>>(
        nodes, perm, n, dim, queries, order, q, k, dists, idxs);
  } else {
    knn_exclude_kernel<Nodes, List><<<blocks, kThreads, 0, stream>>>(
        nodes, perm, n, dim, queries, order, lab.nodes, lab.queries, q, k,
        dists, idxs);
  }
}

template <class Nodes>
cudaError_t launch_knn_k(const Nodes& nodes, const int* perm, int n, int dim,
                         const float* queries, const int* order, int q, int k,
                         float* d, int* ix, Labels lab, cudaStream_t s) {
  using knn::KeyHeap;
  using knn::KeyList;
  if (k <= 1) launch_knn<Nodes, KeyList<1, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else if (k <= 2) launch_knn<Nodes, KeyList<2, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else if (k <= 4) launch_knn<Nodes, KeyList<4, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else if (k <= 8) launch_knn<Nodes, KeyList<8, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else if (k <= 16) launch_knn<Nodes, KeyList<16, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else if (k <= 32) launch_knn<Nodes, KeyList<32, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else if (k <= kMaxK) launch_knn<Nodes, KeyHeap<kMaxK, true>>(nodes, perm, n, dim, queries, order, q, k, d, ix, lab, s);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// records: the tree's LBVH.records in 3-D (spatial_kernel3), or null (the
// flat arrays); order: the query each thread walks (with records only),
// or null; min_pos: (q,) int32 pair filter, or null (none). The kernels
// write every slot of buf (the matches, then -1).
REPRO_EXPORT int bvh_spatial_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* range_last, const void* perm,
    const void* records, const void* order, const void* qlo, const void* qhi,
    const void* radius, const void* min_pos, int n, int q, int dim, int cap,
    int fine_sqrt, void* counts, void* buf, void* stream) {
  if (dim < 1 || dim > kMaxDim || cap < 1 || n < 2 ||
      (records != nullptr && dim != 3) ||
      (order != nullptr && records == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (q + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  auto rl = static_cast<const int*>(range_last);
  auto lo = static_cast<const float*>(qlo);
  auto hi = static_cast<const float*>(qhi);
  auto r = static_cast<const float*>(radius);
  auto mp = static_cast<const int*>(min_pos);
  auto c = static_cast<int*>(counts);
  auto b = static_cast<int*>(buf);
  if (records != nullptr) {
    auto rec = static_cast<const int4*>(records);
    auto od = static_cast<const int*>(order);
    if (fine_sqrt) {
      spatial_kernel3<true><<<blocks, kThreads, 0, s>>>(rec, rl, n, lo, hi, r,
                                                        mp, od, q, cap, c, b);
    } else {
      spatial_kernel3<false><<<blocks, kThreads, 0, s>>>(rec, rl, n, lo, hi, r,
                                                         mp, od, q, cap, c, b);
    }
    return static_cast<int>(cudaGetLastError());
  }
  Tree t{static_cast<const float*>(node_lo), static_cast<const float*>(node_hi),
         static_cast<const int*>(rope), static_cast<const int*>(left),
         static_cast<const int*>(perm), n, dim};
  if (fine_sqrt) {
    spatial_kernel<true><<<blocks, kThreads, 0, s>>>(t, rl, lo, hi, r, mp, q,
                                                     cap, c, b);
  } else {
    spatial_kernel<false><<<blocks, kThreads, 0, s>>>(t, rl, lo, hi, r, mp, q,
                                                      cap, c, b);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

int knn_entry(const void* node_lo, const void* node_hi, const void* rope,
              const void* left, const void* perm, const void* records,
              const void* order, const void* queries, Labels lab, int n,
              int q, int dim, int k, void* dists, void* idxs, void* stream) {
  if (dim < 1 || dim > kMaxDim || k < 1 || k > kMaxK || n < 2 ||
      (records != nullptr && dim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto pm = static_cast<const int*>(perm);
  auto qp = static_cast<const float*>(queries);
  auto od = static_cast<const int*>(order);
  auto d = static_cast<float*>(dists);
  auto ix = static_cast<int*>(idxs);
  auto s = static_cast<cudaStream_t>(stream);
  if (records != nullptr) {
    return static_cast<int>(launch_knn_k(
        Records3{static_cast<const int4*>(records)}, pm, n, dim, qp, od, q, k,
        d, ix, lab, s));
  }
  Tree t{static_cast<const float*>(node_lo), static_cast<const float*>(node_hi),
         static_cast<const int*>(rope), static_cast<const int*>(left), pm, n,
         dim};
  return static_cast<int>(launch_knn_k(Flat{t}, pm, n, dim, qp, od, q, k, d,
                                       ix, lab, s));
}

}  // namespace

// records: the tree's LBVH.records in 3-D (the Records3 instance), or
// null (the flat arrays); order: the query each thread walks, or null
REPRO_EXPORT int bvh_knn_launch(const void* node_lo, const void* node_hi,
                                const void* rope, const void* left,
                                const void* perm, const void* records,
                                const void* order, const void* queries, int n,
                                int q, int dim, int k, void* dists,
                                void* idxs, void* stream) {
  return knn_entry(node_lo, node_hi, rope, left, perm, records, order,
                   queries, Labels{}, n, q, dim, k, dists, idxs, stream);
}

// the exclusion walk (Nearest.exclude): as bvh_knn_launch, with the
// tree's (2n-1,) int32 node labels and the (q,) int32 query labels; the
// distances written are the keys, sqrtf(d2)
REPRO_EXPORT int bvh_knn_exclude_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* perm, const void* records,
    const void* order, const void* queries, const void* node_labels,
    const void* query_labels, int n, int q, int dim, int k, void* dists,
    void* idxs, void* stream) {
  if (node_labels == nullptr || query_labels == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Labels lab{static_cast<const int*>(node_labels),
                   static_cast<const int*>(query_labels)};
  return knn_entry(node_lo, node_hi, rope, left, perm, records, order,
                   queries, lab, n, q, dim, k, dists, idxs, stream);
}
