// The LBVH build's tail: from the Karras ranges (first, last, gamma) and
// the Morton permutation, every field of the tree but range_first, and in
// 3-D the (2N-1, 8) int32 node records that the 3-D walks read; and the
// refit, the same bottom-up pass over a kept topology.
//
// Replaces: the XLA ops of src/repro/core/lbvh.py::_build_impl after the
//   Karras search (the Apetrei links, the RMQ sparse-table AABBs
//   kernels/lbvh_build.py::aabb_rmq, the ropes in closed form), and of
//   refit; no pallas_call of its own (port-only). Node numbering as the
//   reference: internal 0..N-2 (root 0), leaves N-1..2N-2 (leaf id = N-1
//   + sorted position); rope -1 ends the walk.
// Bound on this card: bytes. A build reads the ranges (12 B an internal
//   node), the permutation (8 B a leaf) and the boxes (2 dim floats a
//   leaf), and writes the fields and records: 184 bytes a leaf in 3-D,
//   2^20 leaves move 193 MB, 58 us at 3.35 TB/s. The climb's atomics and
//   its dependent loads (a node's links, then its sibling's record) are
//   latency along a path as long as the tree is deep.
// Design: ArborX's own construction (Apetrei 2014) instead of the
//   reference's sparse table, which costs (max_log2 + 1) x N x 2 dim
//   floats (504 MiB at N = 2^20) and two launches a level:
//   * pass 1, one thread per internal node: its children from (first,
//     last, gamma) (a child is a leaf when it coincides with the range's
//     end), split_owner[gamma] = i, each child's parent, range_last, and
//     the node's arrival counter set to 0;
//   * pass 1b, one thread per node: the ropes in closed form, so the
//     climb reads a node's rope beside its links instead of two dependent
//     loads after its arrival;
//   * pass 2, one thread per leaf: the leaf box gathered through the
//     permutation, the leaf's fields and record; then the thread climbs:
//     at each parent an atomic increment of its counter (acq_rel at gpu
//     scope, no separate fence; the parent's links, read-only in this
//     pass, load beside it), and the first thread to arrive stops; the
//     second reads the sibling's box from its record in L2 (__ldcg: the
//     sibling wrote it before its own release), combines the two (left
//     first), and writes the parent's box and record.
//   rope(node covering [f, l]) = -1 when l = N-1, else
//   right_child(split_owner(l)), as the reference's closed form. Min and
//   max are exact, so the order in which boxes combine changes no float
//   except in two places, both settled as the reference: a NaN propagates
//   (jnp.minimum / maximum), and -0 < +0 (XLA:CPU's minimum of -0 and +0
//   is -0 in either order, its maximum +0), so the result depends on no
//   order. Other dims take the generic instance (boxes combined from
//   memory, no records).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// jnp.minimum / jnp.maximum as XLA computes them: NaN propagates, and
// -0 < +0
__device__ __forceinline__ float min_box(float a, float b) {
  if (a < b || a != a) return a;
  if (b < a || b != b) return b;
  return __int_as_float(__float_as_int(a) | __float_as_int(b));
}
__device__ __forceinline__ float max_box(float a, float b) {
  if (a > b || a != a) return a;
  if (b > a || b != b) return b;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

// one arrival at a node's counter: the old count. acq_rel at gpu scope:
// this thread's writes before it (its node's box and record) are visible
// to the thread that arrives second, and that thread sees them after it
__device__ __forceinline__ int arrive(int* flag) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(flag)
               : "memory");
  return old;
}

struct Tree {
  // inputs
  const int* __restrict__ first;     // build: the Karras ranges
  const int* __restrict__ last;
  const int* __restrict__ gamma;
  const long long* __restrict__ perm;  // build: sorted position -> index
  const float* __restrict__ box_lo;  // (n, dim), the caller's order
  const float* __restrict__ box_hi;
  // fields (the refit reads left, right, rope and leaf_perm)
  float* node_lo;                    // (2n-1, dim)
  float* node_hi;
  int* left;                         // (n-1,)
  int* right;
  int* rope;                         // (2n-1,)
  int* range_last;                   // (2n-1,)
  int* leaf_perm;                    // (n,)
  int4* records;                     // (2n-1, 8) int32 in 3-D, else null
  // scratch
  int* parent;                       // (2n-1,)
  int* owner;                        // (n-1,): split position -> node
  int* flags;                        // (n-1,): arrivals at each node
  int n, dim;
};

// pass 1 of a build: links, split owners, parents, arrival counters
__global__ void __launch_bounds__(kThreads) link_kernel(Tree t) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= t.n - 1) return;
  const int n1 = t.n - 1;
  const int g = t.gamma[i], f = t.first[i], l = t.last[i];
  const int lc = g == f ? n1 + g : g;
  const int rc = g + 1 == l ? n1 + g + 1 : g + 1;
  t.left[i] = lc;
  t.right[i] = rc;
  t.range_last[i] = l;
  t.owner[g] = i;
  t.parent[lc] = i;
  t.parent[rc] = i;
  t.flags[i] = 0;
  if (i == 0) t.parent[0] = -1;
}

// pass 1 of a refit: parents and arrival counters from the kept links
__global__ void __launch_bounds__(kThreads) parent_kernel(Tree t) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= t.n - 1) return;
  t.parent[t.left[i]] = i;
  t.parent[t.right[i]] = i;
  t.flags[i] = 0;
  if (i == 0) t.parent[0] = -1;
}

// pass 1b of a build, one thread per node: range_last of a leaf, and the
// ropes in closed form from pass 1's links and split owners
__global__ void __launch_bounds__(kThreads) rope_kernel(Tree t) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int n1 = t.n - 1;
  if (k >= n1 + t.n) return;
  const int last = k < n1 ? __ldg(t.last + k) : k - n1;
  if (k >= n1) t.range_last[k] = last;
  t.rope[k] = last >= n1 ? -1 : __ldg(t.right + __ldg(t.owner + last));
}

// the rope of a node (pass 1b's, or the kept tree's in a refit)
__device__ __forceinline__ int rope_at(const Tree& t, int node) {
  return __ldg(t.rope + node);
}

__device__ __forceinline__ void write_record(const Tree& t, int node,
                                             const float (&lo)[3],
                                             const float (&hi)[3], int rope,
                                             int link) {
  t.records[2 * node] = make_int4(__float_as_int(lo[0]), __float_as_int(lo[1]),
                                  __float_as_int(lo[2]), rope);
  t.records[2 * node + 1] = make_int4(__float_as_int(hi[0]),
                                      __float_as_int(hi[1]),
                                      __float_as_int(hi[2]), link);
}

// pass 2 in 3-D: boxes in registers, the sibling's box from its record
template <bool kBuild>
__global__ void __launch_bounds__(kThreads) climb_kernel3(Tree t) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= t.n) return;
  const int n1 = t.n - 1;
  const long long src = kBuild ? t.perm[p] : t.leaf_perm[p];
  int node = n1 + p;
  const int leaf_rope = rope_at(t, node);
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = __ldg(t.box_lo + src * 3 + k);
    hi[k] = __ldg(t.box_hi + src * 3 + k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.node_lo[node * 3LL + k] = lo[k];
    t.node_hi[node * 3LL + k] = hi[k];
  }
  if (kBuild) t.leaf_perm[p] = static_cast<int>(src);
  write_record(t, node, lo, hi, leaf_rope, static_cast<int>(src));
  for (int cur = __ldg(t.parent + node); cur >= 0;) {
    // cur's links and rope (read-only in this pass) load beside the arrival
    const int l = __ldg(t.left + cur), r = __ldg(t.right + cur);
    const int up = __ldg(t.parent + cur);
    const int rope = rope_at(t, cur);
    if (arrive(t.flags + cur) == 0) return;  // the sibling goes on
    const int sib = l == node ? r : l;
    const int4 a = __ldcg(t.records + 2 * sib);
    const int4 b = __ldcg(t.records + 2 * sib + 1);
    const float slo[3] = {__int_as_float(a.x), __int_as_float(a.y),
                          __int_as_float(a.z)};
    const float shi[3] = {__int_as_float(b.x), __int_as_float(b.y),
                          __int_as_float(b.z)};
    const bool mine_left = l == node;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = mine_left ? min_box(lo[k], slo[k]) : min_box(slo[k], lo[k]);
      hi[k] = mine_left ? max_box(hi[k], shi[k]) : max_box(shi[k], hi[k]);
      t.node_lo[cur * 3LL + k] = lo[k];
      t.node_hi[cur * 3LL + k] = hi[k];
    }
    write_record(t, cur, lo, hi, rope, l);
    node = cur;
    cur = up;
  }
}

// pass 2 in any dim: boxes combined from the node arrays in L2
template <bool kBuild>
__global__ void __launch_bounds__(kThreads) climb_kernel(Tree t) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= t.n) return;
  const int n1 = t.n - 1, dim = t.dim;
  const long long src = kBuild ? t.perm[p] : t.leaf_perm[p];
  int node = n1 + p;
  for (int k = 0; k < dim; ++k) {
    t.node_lo[node * static_cast<long long>(dim) + k] =
        __ldg(t.box_lo + src * dim + k);
    t.node_hi[node * static_cast<long long>(dim) + k] =
        __ldg(t.box_hi + src * dim + k);
  }
  if (kBuild) t.leaf_perm[p] = static_cast<int>(src);
  for (int cur = __ldg(t.parent + node); cur >= 0;) {
    const long long l = __ldg(t.left + cur), r = __ldg(t.right + cur);
    const int up = __ldg(t.parent + cur);
    if (arrive(t.flags + cur) == 0) return;
    const long long c = cur;
    for (int k = 0; k < dim; ++k) {
      t.node_lo[c * dim + k] = min_box(__ldcg(t.node_lo + l * dim + k),
                                       __ldcg(t.node_lo + r * dim + k));
      t.node_hi[c * dim + k] = max_box(__ldcg(t.node_hi + l * dim + k),
                                       __ldcg(t.node_hi + r * dim + k));
    }
    node = cur;
    cur = up;
  }
}

int blocks_of(int items) { return (items + kThreads - 1) / kThreads; }

template <bool kBuild>
int launch(Tree t, cudaStream_t s) {
  if (t.n < 2 || t.dim < 1 || (t.dim == 3) != (t.records != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kBuild) {
    link_kernel<<<blocks_of(t.n - 1), kThreads, 0, s>>>(t);
    rope_kernel<<<blocks_of(2 * t.n - 1), kThreads, 0, s>>>(t);
  } else {
    parent_kernel<<<blocks_of(t.n - 1), kThreads, 0, s>>>(t);
  }
  if (t.dim == 3) {
    climb_kernel3<kBuild><<<blocks_of(t.n), kThreads, 0, s>>>(t);
  } else {
    climb_kernel<kBuild><<<blocks_of(t.n), kThreads, 0, s>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A build. first / last / gamma (n-1,) int32 (the Karras ranges), perm
// (n,) int64 (sorted position -> index), box_lo / box_hi (n, dim) float32
// in the caller's order. Writes node_lo / node_hi (2n-1, dim) float32,
// left / right (n-1,), rope / range_last (2n-1,), leaf_perm (n,) int32,
// and in 3-D (only) records (2n-1, 8) int32. scratch: (4n - 3,) int32.
REPRO_EXPORT int lbvh_tail_launch(const void* first, const void* last,
                                  const void* gamma, const void* perm,
                                  const void* box_lo, const void* box_hi,
                                  int n, int dim, void* node_lo,
                                  void* node_hi, void* left, void* right,
                                  void* rope, void* range_last,
                                  void* leaf_perm, void* records,
                                  void* scratch, void* stream) {
  auto sc = static_cast<int*>(scratch);
  Tree t{static_cast<const int*>(first), static_cast<const int*>(last),
         static_cast<const int*>(gamma), static_cast<const long long*>(perm),
         static_cast<const float*>(box_lo), static_cast<const float*>(box_hi),
         static_cast<float*>(node_lo), static_cast<float*>(node_hi),
         static_cast<int*>(left), static_cast<int*>(right),
         static_cast<int*>(rope), static_cast<int*>(range_last),
         static_cast<int*>(leaf_perm), static_cast<int4*>(records), sc,
         sc + 2 * n - 1, sc + 3 * n - 2, n, dim};
  return launch<true>(t, static_cast<cudaStream_t>(stream));
}

// A refit over a kept topology: left / right (n-1,), rope (2n-1,),
// leaf_perm (n,) int32; box_lo / box_hi (n, dim) float32 in the caller's
// order. Writes node_lo / node_hi and in 3-D (only) the records.
// scratch: (4n - 3,) int32.
REPRO_EXPORT int lbvh_refit_launch(const void* left, const void* right,
                                   const void* rope, const void* leaf_perm,
                                   const void* box_lo, const void* box_hi,
                                   int n, int dim, void* node_lo,
                                   void* node_hi, void* records,
                                   void* scratch, void* stream) {
  auto sc = static_cast<int*>(scratch);
  Tree t{nullptr, nullptr, nullptr, nullptr,
         static_cast<const float*>(box_lo), static_cast<const float*>(box_hi),
         static_cast<float*>(node_lo), static_cast<float*>(node_hi),
         const_cast<int*>(static_cast<const int*>(left)),
         const_cast<int*>(static_cast<const int*>(right)),
         const_cast<int*>(static_cast<const int*>(rope)), nullptr,
         const_cast<int*>(static_cast<const int*>(leaf_perm)),
         static_cast<int4*>(records), sc, sc + 2 * n - 1, sc + 3 * n - 2, n,
         dim};
  return launch<false>(t, static_cast<cudaStream_t>(stream));
}
