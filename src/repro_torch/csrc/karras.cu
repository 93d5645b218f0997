// Karras ranges of an LBVH: for every internal node i, the sorted-leaf
// range [first, last] it covers and its split gamma.
//
// Replaces: src/repro/kernels/lbvh_build.py::karras_ranges_pallas (body
//   _karras_kernel). Same arithmetic: delta(i, j) is the common-prefix
//   length of the 96-bit keys (hi | lo | idx), computed with xor and clz,
//   -1 outside [0, n-1]; the direction d compares delta to both
//   neighbours; one descending power-of-two search finds the range end,
//   a second one the split. Output integers equal the plain twin's.
// Bound on this card: each thread does 2 * (max_log2 + 1) + 3 probes of
//   three 4-byte keys at data-dependent positions, about 12 integer
//   operations each; the keys (12 B per leaf, 12 MB at 2^20 leaves) fit
//   the 50 MB L2, so after the first touch the probes are L2 hits and the
//   kernel is bound by L2 latency and integer throughput, not HBM bytes.
// Design: one thread per internal node, no padded lanes (the TPU kernel
//   recomputed node n-2 in its padding); keys read through __ldg; each
//   search is a loop over max_log2 + 1 bits with its state in registers.
#include "common.cuh"

namespace {

struct Keys {
  const uint32_t* __restrict__ hi;
  const uint32_t* __restrict__ lo;
  const uint32_t* __restrict__ idx;
  int n;
};

__device__ __forceinline__ int delta(const Keys& k, int i, int j) {
  if (j < 0 || j > k.n - 1) return -1;
  const uint32_t hx = __ldg(k.hi + i) ^ __ldg(k.hi + j);
  const uint32_t lx = __ldg(k.lo + i) ^ __ldg(k.lo + j);
  const uint32_t ix = __ldg(k.idx + i) ^ __ldg(k.idx + j);
  if (hx != 0) return __clz(static_cast<int>(hx));
  if (lx != 0) return 32 + __clz(static_cast<int>(lx));
  return 64 + __clz(static_cast<int>(ix));
}

__global__ void karras_kernel(Keys k, int max_log2, int* __restrict__ first,
                              int* __restrict__ last, int* __restrict__ gamma) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k.n - 1) return;

  const int d_r = delta(k, i, i + 1);
  const int d_l = delta(k, i, i - 1);
  const int d = d_r > d_l ? 1 : -1;
  const int delta_min = d > 0 ? d_l : d_r;

  int l = 0;
  for (int b = max_log2; b >= 0; --b) {
    const int t = 1 << b;
    if (delta(k, i, i + (l + t) * d) > delta_min) l += t;
  }
  const int j = i + l * d;
  first[i] = min(i, j);
  last[i] = max(i, j);

  const int delta_node = delta(k, i, j);
  int s = 0;
  for (int b = max_log2; b >= 0; --b) {
    const int t = 1 << b;
    if (delta(k, i, i + (s + t) * d) > delta_node) s += t;
  }
  gamma[i] = i + s * d + min(d, 0);
}

}  // namespace

REPRO_EXPORT int karras_ranges_launch(const void* hi, const void* lo,
                                      const void* idx, int n, int max_log2,
                                      void* first, void* last, void* gamma,
                                      void* stream) {
  const int threads = 256;
  const int blocks = (n - 1 + threads - 1) / threads;
  Keys k{static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
         static_cast<const uint32_t*>(idx), n};
  if (blocks > 0) {
    karras_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        k, max_log2, static_cast<int*>(first), static_cast<int*>(last),
        static_cast<int*>(gamma));
  }
  return static_cast<int>(cudaGetLastError());
}
