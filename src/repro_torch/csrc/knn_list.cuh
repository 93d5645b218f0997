// The k-best list of the two k-nearest kernels (bvh_traverse.cu's walk and
// bruteforce_knn.cu's scan), ordered by a key of (d2, position).
//
// A list holds up to k candidates, ascending by the key, padded with
// (inf, -1). The key is d2, then the position: ascending for brute force
// (kLaterFirst = false: the twin's stable sort keeps the lower index
// first), descending for the walk (kLaterFirst = true: the rope walk's
// sorted insert places a new leaf before the equal entries, which it
// reached earlier, at lower positions). Two admission tests:
// admits_strict(d2) is the twins' d2 < tau (the k-th entry's d2), and
// admits(d2, pos) takes a key below the k-th entry's key, in whatever
// order the candidates come. Either way a d2 that is inf or NaN never
// enters (inf < inf and NaN < x are false, and a tie needs a finite
// k-th d2), and no two candidates share a key, since positions are
// distinct.
//
// KeyList<K, kLaterFirst> (K <= 32): the sorted list in registers; an
//   insert counts the entries with a smaller key and shifts the rest by
//   one, fully unrolled.
// KeyHeap<K, kLaterFirst> (up to K entries, k of them used): a max-heap on
//   the key in local memory: the walk's large k buckets, where a sorted
//   insert would shift ~k/2 entries in local memory, and every list of
//   the brute-force scan, where the register lists cost the hot loop its
//   registers. A replacement sifts down log2(k) levels. finish() sorts it
//   ascending (heapsort), after which dist(j) / pos(j) read the list as
//   KeyList's.
// Both give `bound()`, the k-th entry's d2 (inf until k entries are in),
// `bound_pos()`, its position (-1 until then: the entry an insert
// evicts), and `first_pos()`, the position of the smallest key so far
// (-1 when the list is empty), which brute force's k > N tail reads.
#pragma once

#include <cmath>

namespace knn {

template <bool kLaterFirst>
__device__ __forceinline__ bool key_less(float a, int pa, float b, int pb) {
  return a < b || (a == b && (kLaterFirst ? pa > pb : pa < pb));
}

template <int K, bool kLaterFirst>
struct KeyList {
  static constexpr int kSlots = K;
  static constexpr bool kInRegisters = true;
  float d[K];
  int p[K];
  float td;  // the k-th entry: the admission bound
  int tp;

  __device__ __forceinline__ void init(int) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = INFINITY;
      p[j] = -1;
    }
    td = INFINITY;
    tp = -1;
  }
  __device__ __forceinline__ float bound() const { return td; }
  __device__ __forceinline__ int bound_pos() const { return tp; }
  __device__ __forceinline__ bool admits(float d2, int pos) const {
    return d2 < td ||
           (d2 == td && td != INFINITY && (kLaterFirst ? pos > tp : pos < tp));
  }
  // the twins' strict test, d2 < tau
  __device__ __forceinline__ bool admits_strict(float d2) const {
    return d2 < td;
  }
  // precondition: the key is below the k-th (admits, or admits_strict).
  // Entries past k hold keys above the k-th, so counting over all K
  // slots gives the same place.
  __device__ __forceinline__ void insert(float d2, int pos, int k) {
    int at = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      at += key_less<kLaterFirst>(d[j], p[j], d2, pos) ? 1 : 0;
    }
    place(d2, pos, k, at);
  }
  // the new entry at slot `at`, the ones from there on one slot down
  __device__ __forceinline__ void place(float d2, int pos, int k, int at) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (j > at) {
        d[j] = d[j - 1];
        p[j] = p[j - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j == at) {
        d[j] = d2;
        p[j] = pos;
      }
      if (j == k - 1) {
        td = d[j];
        tp = p[j];
      }
    }
  }
  // insert() for a candidate whose position exceeds every entry's (a
  // scan in ascending position, ascending keys): the equal entries come
  // first, so the place is the count of entries with d <= d2
  __device__ __forceinline__ void insert_later(float d2, int pos, int k) {
    static_assert(!kLaterFirst, "insert_later orders ties by position");
    int at = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) at += d[j] <= d2 ? 1 : 0;
    place(d2, pos, k, at);
  }
  __device__ __forceinline__ int first_pos() const { return p[0]; }
  __device__ __forceinline__ void finish(int) {}
  __device__ __forceinline__ float dist(int j) const { return d[j]; }
  __device__ __forceinline__ int pos(int j) const { return p[j]; }
};

template <int K, bool kLaterFirst>
struct KeyHeap {
  static constexpr int kSlots = K;
  static constexpr bool kInRegisters = false;
  float d[K];
  int p[K];
  int n;         // k: the heap's size
  float td;      // d[0], the root's (the k-th) d2, kept in a register
  float lo_d;    // the smallest key so far (first_pos)
  int lo_p;

  __device__ __forceinline__ void init(int k) {
    n = k;
    for (int j = 0; j < k; ++j) {
      d[j] = INFINITY;
      p[j] = -1;
    }
    td = INFINITY;
    lo_d = INFINITY;
    lo_p = -1;
  }
  __device__ __forceinline__ float bound() const { return td; }
  __device__ __forceinline__ int bound_pos() const { return p[0]; }
  __device__ __forceinline__ bool admits(float d2, int pos) const {
    return d2 < td || (d2 == td && td != INFINITY &&
                       (kLaterFirst ? pos > p[0] : pos < p[0]));
  }
  __device__ __forceinline__ bool admits_strict(float d2) const {
    return d2 < td;
  }
  // the new key takes the root's place (the k-th, which leaves), then
  // sifts down within [0, m)
  __device__ __forceinline__ void sift(float d2, int pos, int m) {
    int j = 0;
    for (;;) {
      int c = 2 * j + 1;
      if (c >= m) break;
      if (c + 1 < m && key_less<kLaterFirst>(d[c], p[c], d[c + 1], p[c + 1])) {
        ++c;
      }
      if (!key_less<kLaterFirst>(d2, pos, d[c], p[c])) break;
      d[j] = d[c];
      p[j] = p[c];
      j = c;
    }
    d[j] = d2;
    p[j] = pos;
  }
  __device__ __forceinline__ void insert(float d2, int pos, int) {
    if (n == 1 || key_less<kLaterFirst>(d2, pos, lo_d, lo_p)) {
      lo_d = d2;
      lo_p = pos;
    }
    sift(d2, pos, n);
    td = d[0];
  }
  __device__ __forceinline__ void insert_later(float d2, int pos, int k) {
    insert(d2, pos, k);
  }
  __device__ __forceinline__ int first_pos() const { return lo_p; }
  // heapsort: the largest key to the end, n - 1 times
  __device__ __forceinline__ void finish(int) {
    for (int m = n - 1; m > 0; --m) {
      const float td = d[m];
      const int tp = p[m];
      d[m] = d[0];
      p[m] = p[0];
      sift(td, tp, m);
    }
  }
  __device__ __forceinline__ float dist(int j) const { return d[j]; }
  __device__ __forceinline__ int pos(int j) const { return p[j]; }
};

}  // namespace knn
