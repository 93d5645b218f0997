// Stackless rope-walk BVH traversal: spatial count + fill, and k-nearest.
//
// Replaces: src/repro/kernels/bvh_traverse.py::bvh_traverse_spatial (body
//   _spatial_kernel) and ::bvh_traverse_knn (body _knn_kernel). Each
//   query walks the flat tree from the root: at a node it tests the
//   query against the node box, then moves to left_child (descend) or
//   rope (skip); rope -1 ends the walk. The TPU kernels advanced a block
//   of cursors in lockstep until all were -1; every cursor's walk is
//   independent, so one thread per query running its own loop visits the
//   same node sequence.
// Bound on this card: per visited node a thread reads one node box
//   (2 * dim floats) and two or three int32s at a data-dependent address
//   and does about 6 * dim float operations: a latency-bound pointer
//   chase. The tree (about 75 MB at 2^20 leaves) is larger than the
//   50 MB L2, so the first touch of a node goes to HBM; neighbouring
//   queries (consecutive in the caller's order) share the upper levels.
// Design: the tree is read straight from global memory through the
//   read-only path (__ldg), with no shared-memory staging and no node
//   cap, so any tree that fits device memory works; query coordinates
//   and the kNN candidate list live in registers (the list spills to
//   local memory for the large k buckets). The squared distance is
//   g0*g0, then one explicit fmaf per further dimension (the order
//   XLA:CPU gives the reference kernels, and geometry.sum_sq_fused's); the library is
//   built with --fmad=false so no other product is contracted: the leaf
//   tests equal the reference's bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 256;   // queries per block

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
  const int mp = min_pos[qi];
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
}

// ---------------------------------------------------------------------------
// k-nearest: sorted (d2, index) list of the bucket size K >= k
// ---------------------------------------------------------------------------

template <int K>
__global__ void knn_kernel(Tree t, const float* __restrict__ queries, int q,
                           int k, float* __restrict__ dists,
                           int* __restrict__ idxs) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int dim = t.dim;
  float qc[kMaxDim];
#pragma unroll
  for (int c = 0; c < kMaxDim; ++c) {
    if (c < dim) qc[c] = queries[static_cast<long long>(qi) * dim + c];
  }
  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = __int_as_float(0x7f800000);  // +inf
    best_i[j] = -1;
  }
  // entries past k stay >= the k-th, so the k-th is the prune bound and
  // counting over all K slots gives the same insertion point
  float tau2 = best_d[0];

  int node = 0;
  while (node != -1) {
    const float* lo = t.lo + static_cast<long long>(node) * dim;
    const float* hi = t.hi + static_cast<long long>(node) * dim;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxDim; ++c) {
      if (c < dim) {
        const float g = max_nan(max_nan(__ldg(lo + c) - qc[c],
                                        qc[c] - __ldg(hi + c)), 0.0f);
        d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
      }
    }
    const bool promising = d2 < tau2;   // strict, as the reference
    const bool is_leaf = node >= t.n - 1;
    if (is_leaf) {
      if (promising) {
        const int orig = __ldg(t.perm + (node - (t.n - 1)));
        int pos = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) pos += best_d[j] < d2 ? 1 : 0;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (j > pos) {
            best_d[j] = best_d[j - 1];
            best_i[j] = best_i[j - 1];
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (j == pos) {
            best_d[j] = d2;
            best_i[j] = orig;
          }
          if (j == k - 1) tau2 = best_d[j];
        }
      }
      node = __ldg(t.rope + node);
    } else {
      node = promising ? __ldg(t.left + node) : __ldg(t.rope + node);
    }
  }
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      od[j] = sqrtf(best_d[j]);
      oi[j] = best_i[j];
    }
  }
}

template <int K>
void launch_knn(const Tree& t, const float* queries, int q, int k,
                float* dists, int* idxs, cudaStream_t stream) {
  const int blocks = (q + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(t, queries, q, k, dists, idxs);
}

}  // namespace

REPRO_EXPORT int bvh_spatial_launch(
    const void* node_lo, const void* node_hi, const void* rope,
    const void* left, const void* range_last, const void* perm,
    const void* qlo, const void* qhi, const void* radius, const void* min_pos,
    int n, int q, int dim, int cap, int fine_sqrt, void* counts, void* buf,
    void* stream) {
  if (dim < 1 || dim > kMaxDim || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tree t{static_cast<const float*>(node_lo), static_cast<const float*>(node_hi),
         static_cast<const int*>(rope), static_cast<const int*>(left),
         static_cast<const int*>(perm), n, dim};
  const int blocks = (q + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  auto rl = static_cast<const int*>(range_last);
  auto lo = static_cast<const float*>(qlo);
  auto hi = static_cast<const float*>(qhi);
  auto r = static_cast<const float*>(radius);
  auto mp = static_cast<const int*>(min_pos);
  auto c = static_cast<int*>(counts);
  auto b = static_cast<int*>(buf);
  if (fine_sqrt) {
    spatial_kernel<true><<<blocks, kThreads, 0, s>>>(t, rl, lo, hi, r, mp, q,
                                                     cap, c, b);
  } else {
    spatial_kernel<false><<<blocks, kThreads, 0, s>>>(t, rl, lo, hi, r, mp, q,
                                                      cap, c, b);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int bvh_knn_launch(const void* node_lo, const void* node_hi,
                                const void* rope, const void* left,
                                const void* perm, const void* queries, int n,
                                int q, int dim, int k, void* dists,
                                void* idxs, void* stream) {
  if (dim < 1 || dim > kMaxDim || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tree t{static_cast<const float*>(node_lo), static_cast<const float*>(node_hi),
         static_cast<const int*>(rope), static_cast<const int*>(left),
         static_cast<const int*>(perm), n, dim};
  auto qp = static_cast<const float*>(queries);
  auto d = static_cast<float*>(dists);
  auto ix = static_cast<int*>(idxs);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 1) launch_knn<1>(t, qp, q, k, d, ix, s);
  else if (k <= 2) launch_knn<2>(t, qp, q, k, d, ix, s);
  else if (k <= 4) launch_knn<4>(t, qp, q, k, d, ix, s);
  else if (k <= 8) launch_knn<8>(t, qp, q, k, d, ix, s);
  else if (k <= 16) launch_knn<16>(t, qp, q, k, d, ix, s);
  else if (k <= 32) launch_knn<32>(t, qp, q, k, d, ix, s);
  else if (k <= 64) launch_knn<64>(t, qp, q, k, d, ix, s);
  else if (k <= 128) launch_knn<128>(t, qp, q, k, d, ix, s);
  else if (k <= 256) launch_knn<256>(t, qp, q, k, d, ix, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
