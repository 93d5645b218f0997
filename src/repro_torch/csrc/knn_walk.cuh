// The nearest-first k-best walk and its tie pass, shared by the point
// k-nearest kernel (bvh_traverse.cu's knn_kernel, the key a squared
// point-to-box distance) and the ray one over Points and Boxes values
// (ray_knn.cu's ray_knn_nf_kernel, the key a slab-entry t). The argument
// that the two give the rope-walk twin's lists bit for bit, ties included,
// is in bvh_traverse.cu's note; it needs of the key only that a node's key
// never exceeds that of a leaf below it and that a leaf's key is its fine
// distance.
//
// A Keys object gives `key(m, link, rope)`: node m's key (+inf or NaN
// prunes it), its link (the left child of an internal node, leaf_perm of a
// leaf) and its rope.
#pragma once

#include <cmath>

#include "knn_list.cuh"

namespace knn {

// internal nodes lie at depths 0..95 and the stack holds at most one per
// depth 1..95 (bvh_traverse.cu's note)
constexpr int kStack = 96;

// a leaf at sorted position `pos`: into the list when its key is below
// tau, else the key into `lost`; an insert into a full list evicts the
// k-th entry, whose key goes to `lost` (fminf drops inf and NaN)
template <class List>
__device__ __forceinline__ void offer(List& best, float d, int pos, int k,
                                      float& lost) {
  if (best.admits_strict(d)) {
    lost = fminf(lost, best.bound());
    best.insert(d, pos, k);
  } else {
    lost = fminf(lost, d);
  }
}

// nearest first: at an internal node both children's keys are taken; the
// walk goes on to the nearer promising one and stacks the farther with its
// key, tested again when popped; a leaf child is offered at once. Leaves
// `best` finished (ascending) and `lost` the smallest key left out.
template <class Keys, class List>
__device__ __forceinline__ void nearest_first(const Keys& keys, int n, int k,
                                              List& best, float& lost) {
  best.init(k);
  lost = INFINITY;
  float st_d[kStack];      // pending internal nodes: their key, left child
  int st_link[kStack];
  int top = 0;
  const int leaf0 = n - 1;   // node id of sorted-leaf position 0

  int link, rope;
  const float d_root = keys.key(0, link, rope);
  bool go = best.admits_strict(d_root);
  while (go) {
    // `link` is the left child of an internal node the walk enters
    int link_l, link_r, rope_r;
    const int l = link;
    const float dl = keys.key(l, link_l, rope);
    const int r = rope;   // a left child's rope: its right sibling
    const float dr = keys.key(r, link_r, rope_r);
    // leaf children into the list (one rolled copy of the insert)
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      const int c = side == 0 ? l : r;
      if (c >= leaf0) offer(best, side == 0 ? dl : dr, c - leaf0, k, lost);
    }
    bool go_l = false, go_r = false;
    if (l < leaf0) {
      go_l = best.admits_strict(dl);
      if (!go_l) lost = fminf(lost, dl);
    }
    if (r < leaf0) {
      go_r = best.admits_strict(dr);
      if (!go_r) lost = fminf(lost, dr);
    }
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
        // tau has tightened since the push
        if (best.admits_strict(st_d[top])) {
          link = st_link[top];
          go = true;
          break;
        }
        lost = fminf(lost, st_d[top]);
      }
    }
  }
  best.finish(k);
}

// the tie pass, when a leaf or node at the k-th key dk was left out (a
// rope walk over the nodes keyed <= dk in position order: the first k
// leaves keyed <= dk, the last k - below of those at dk kept), then
// put(j, key, sorted position or -1) for each output slot j < k: the
// list's entries below dk, then the kept leaves at dk, highest position
// first (the last of the ring first)
template <class Keys, class List, class Put>
__device__ __forceinline__ void tie_pass_and_put(const Keys& keys, int n,
                                                 int k, const List& best,
                                                 float lost, Put put) {
  const int leaf0 = n - 1;
  const float dk = best.bound();
  int below = k;      // entries below dk: the twin keeps them all
  int ties = 0;       // leaves at dk among the first k keyed <= dk
  int ring[List::kSlots];   // the last k - below of them, in a ring
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
      const float d = keys.key(node, lk, rp);
      if (!(d <= dk)) {
        node = rp;
      } else if (node < leaf0) {
        node = lk;
      } else {
        ++seen;
        if (d == dk) ring[ties++ % m] = node - leaf0;
        node = rp;
      }
    }
  }
  auto slot = [&](int j) {
    if (j < below) {
      put(j, best.dist(j), best.pos(j));
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

}  // namespace knn
