// Karras ranges of an LBVH: for every internal node i, the sorted-leaf
// range [first, last] it covers and its split gamma.
//
// Replaces: src/repro/kernels/lbvh_build.py::karras_ranges_pallas (body
//   _karras_kernel). Same arithmetic: delta(i, j) is the common-prefix
//   length of the 96-bit keys (hi | lo | idx), computed with xor and clz,
//   -1 outside [0, n-1]; the direction d compares delta to both
//   neighbours; a power-of-two search finds the range end, a second one
//   the split. Output integers equal the plain twin's.
// Bound on this card: a handful of probes per thread, each a key at a
//   data-dependent position and about 12 integer operations; the keys
//   (24 B per leaf as the caller's int64 lanes) fit the 50 MB L2, so
//   after the first touch the probes are L2 hits: bound by L2 latency
//   along each thread's chain of probes, not by HBM bytes.
// Design: one thread per internal node; the kernel reads the caller's
//   int64 lanes and takes their low 32 bits (no conversion pass before
//   it), holds key i in registers, and reads a probe's idx lane only when
//   hi and lo agree (duplicate Morton codes).
//   The searches are bounded, and exact for sorted distinct keys (the
//   twin's contract: its min-table equals the prefix length only there):
//   delta(i, i + m * d) is then non-increasing in m, so "delta > threshold"
//   holds for a prefix m <= M of the steps, and a descending power-of-two
//   search from any bit b with 2^(b+1) > M returns M, as the twin's search
//   from max_log2 does.
//   * range end: M is the range length l; the step doubles (2, 4, ...)
//     until a probe fails (Karras 2012's l_max), which gives such a b;
//   * split: every step m >= l fails (delta(i, i + m * d) <= delta_node),
//     so M < l <= 2^(bit length of l): the search starts at l's top bit.
//   Node i makes 3 + 3 * (floor(log2 l) + 1) probes (the twin 2 * (max_log2
//   + 1) + 3): most internal nodes cover a few leaves.
#include "common.cuh"

namespace {

using Lane = long long;   // one uint32 key lane in each int64

struct Key {
  uint32_t hi, lo, idx;
};

struct Keys {
  const Lane* __restrict__ hi;
  const Lane* __restrict__ lo;
  const Lane* __restrict__ idx;
  int n;

  __device__ __forceinline__ uint32_t lane(const Lane* p, long long j) const {
    return static_cast<uint32_t>(__ldg(p + j));
  }
  __device__ __forceinline__ Key at(long long j) const {
    return Key{lane(hi, j), lane(lo, j), lane(idx, j)};
  }
  // the common-prefix length of key `ki` (key i) and key j; -1 outside
  __device__ __forceinline__ int delta(const Key& ki, long long j) const {
    if (j < 0 || j > n - 1) return -1;
    const uint32_t hx = ki.hi ^ lane(hi, j);
    const uint32_t lx = ki.lo ^ lane(lo, j);
    if (hx != 0) return __clz(static_cast<int>(hx));
    if (lx != 0) return 32 + __clz(static_cast<int>(lx));
    return 64 + __clz(static_cast<int>(ki.idx ^ lane(idx, j)));
  }
};

__global__ void karras_kernel(Keys k, int* __restrict__ first,
                              int* __restrict__ last, int* __restrict__ gamma) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k.n - 1) return;
  const Key ki = k.at(i);

  const int d_r = k.delta(ki, i + 1);
  const int d_l = k.delta(ki, i - 1);
  const int d = d_r > d_l ? 1 : -1;
  const int delta_min = d > 0 ? d_l : d_r;

  // range end: double the step past the range, then descend
  long long l_max = 2;
  while (k.delta(ki, i + l_max * d) > delta_min) l_max <<= 1;
  int l = 0;
  for (long long t = l_max >> 1; t > 0; t >>= 1) {
    if (k.delta(ki, i + (l + t) * d) > delta_min) l += static_cast<int>(t);
  }
  const int j = i + l * d;
  first[i] = min(i, j);
  last[i] = max(i, j);

  // split: the largest passing step is below l (l >= 1: delta(i, i + d)
  // exceeds delta_min for distinct keys)
  const int delta_node = k.delta(ki, j);
  int s = 0;
  for (int t = l > 0 ? 1 << (31 - __clz(l)) : 0; t > 0; t >>= 1) {
    if (k.delta(ki, i + static_cast<long long>(s + t) * d) > delta_node) {
      s += t;
    }
  }
  gamma[i] = i + s * d + min(d, 0);
}

}  // namespace

// hi, lo, idx: (n,) int64 lanes holding uint32 values (the sorted keys)
REPRO_EXPORT int karras_ranges_launch(const void* hi, const void* lo,
                                      const void* idx, int n, void* first,
                                      void* last, void* gamma, void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n - 1 + threads - 1) / threads;
  Keys k{static_cast<const Lane*>(hi), static_cast<const Lane*>(lo),
         static_cast<const Lane*>(idx), n};
  karras_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<int*>(first), static_cast<int*>(last),
      static_cast<int*>(gamma));
  return static_cast<int>(cudaGetLastError());
}
