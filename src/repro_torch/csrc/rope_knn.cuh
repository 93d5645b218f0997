// The k-nearest rope walk of the twins' loop (core.traversal.knn_walk),
// shared by the ray kNN walk (ray_knn.cu's ray_knn_kernel, the key a
// slab-entry t, the leaf key a hit t) and the fine kNN walk (fine_knn.cu,
// the key a box distance, the leaf key a fine distance); the node loaders
// both read, the list's output, and the k buckets of the launch.
//
// The walk descends to the left child while a node's key is strictly
// below the running k-th best (tau), else escapes by the rope; at a leaf
// it admits the value when its box key and its leaf key are both below
// tau. The list orders entries by (key, sorted-leaf position descending):
// the walk reaches leaves in ascending position, so that order places a
// new leaf before the equal entries, as the twin's insert does, and the
// lists equal the twin's bit for bit, ties and the (inf, -1) padding
// included, by construction, whatever the leaf key.
//
// A Walk gives `key(m, link, rope)`: node m's key (+inf or NaN prunes it),
// its link (the left child of an internal node, leaf_perm of a leaf) and
// its rope; and `leaf(pos, link, kb)`: the key of the leaf at sorted
// position `pos`, given its original index `link` and its node key `kb`.
#pragma once

#include <cmath>

#include "common.cuh"
#include "knn_list.cuh"

namespace knn {

// 3-D node records: node m is rec[2m] = (lo.xyz, rope) and rec[2m + 1] =
// (hi.xyz, left child of an internal node | leaf_perm of a leaf)
struct NodeRecords3 {
  static constexpr int N = 3;
  const int4* __restrict__ rec;

  __device__ __forceinline__ void load(int m, int, float (&lo)[3],
                                       float (&hi)[3], int& link,
                                       int& rope) const {
    const int4 a = __ldg(rec + 2 * static_cast<long long>(m));
    const int4 b = __ldg(rec + 2 * static_cast<long long>(m) + 1);
    lo[0] = __int_as_float(a.x);
    lo[1] = __int_as_float(a.y);
    lo[2] = __int_as_float(a.z);
    hi[0] = __int_as_float(b.x);
    hi[1] = __int_as_float(b.y);
    hi[2] = __int_as_float(b.z);
    link = b.w;
    rope = a.w;
  }
};

// any dim up to D: the flat arrays
template <int D>
struct NodeFlat {
  static constexpr int N = D;
  const float* __restrict__ lo;     // (2n-1, dim)
  const float* __restrict__ hi;     // (2n-1, dim)
  const int* __restrict__ rope;     // (2n-1,)
  const int* __restrict__ left;     // (n-1,)
  const int* __restrict__ perm;     // (n,)
  int n;

  __device__ __forceinline__ void load(int m, int dim, float (&l)[D],
                                       float (&h)[D], int& link,
                                       int& rp) const {
    const long long o = static_cast<long long>(m) * dim;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      if (c < dim) {
        l[c] = __ldg(lo + o + c);
        h[c] = __ldg(hi + o + c);
      }
    }
    links(m, link, rp);
  }
  // node m's link and rope alone
  __device__ __forceinline__ void links(int m, int& link, int& rp) const {
    link = m < n - 1 ? __ldg(left + m) : __ldg(perm + (m - (n - 1)));
    rp = __ldg(rope + m);
  }
};

// the twin's node sequence with its running k-th best; leaves `best`
// finished (ascending)
template <class Walk, class List>
__device__ __forceinline__ void rope_walk(Walk& walk, int n, int k,
                                          List& best) {
  best.init(k);
  const int leaf0 = n - 1;   // node id of sorted-leaf position 0
  int node = 0;
  while (node != -1) {
    int link, rope;
    const float kb = walk.key(node, link, rope);
    const bool promising = best.admits_strict(kb);
    if (node < leaf0) {
      node = promising ? link : rope;
      continue;
    }
    if (promising) {
      const int pos = node - leaf0;
      const float d = walk.leaf(pos, link, kb);
      if (best.admits_strict(d)) best.insert(d, pos, k);
    }
    node = rope;
  }
  best.finish(k);
}

// a finished list into one query's row of the (q, k) outputs, positions
// mapped to original indices through leaf_perm, -1 kept
template <class List>
__device__ __forceinline__ void put_list(const List& best, int k,
                                         const int* __restrict__ perm,
                                         float* od, int* oi) {
  if constexpr (List::kInRegisters) {
#pragma unroll
    for (int j = 0; j < List::kSlots; ++j) {
      if (j < k) {
        const int p = best.pos(j);
        od[j] = best.dist(j);
        oi[j] = p < 0 ? -1 : __ldg(perm + p);
      }
    }
  } else {
    for (int j = 0; j < k; ++j) {
      const int p = best.pos(j);
      od[j] = best.dist(j);
      oi[j] = p < 0 ? -1 : __ldg(perm + p);
    }
  }
}

template <class L>
struct ListTag {
  using type = L;
};

// launch(ListTag<List>()) with the list of k's bucket: KeyList in
// registers up to k = 32, KeyHeap<kMaxK> in local memory above
template <int kMaxK, class Launch>
cudaError_t with_list(int k, Launch launch) {
  if (k < 1) return cudaErrorInvalidValue;
  if (k <= 1) launch(ListTag<KeyList<1, true>>());
  else if (k <= 4) launch(ListTag<KeyList<4, true>>());
  else if (k <= 8) launch(ListTag<KeyList<8, true>>());
  else if (k <= 16) launch(ListTag<KeyList<16, true>>());
  else if (k <= 32) launch(ListTag<KeyList<32, true>>());
  else if (k <= kMaxK) launch(ListTag<KeyHeap<kMaxK, true>>());
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace knn
