// 64-bit Morton codes: each point quantized to `bits` per dimension inside
// the scene bounds, its bits interleaved into one 64-bit code, returned as
// two int64 lanes that each hold an unsigned 32-bit half (hi, lo), the
// convention of repro_torch.core.morton.
//
// Replaces: src/repro/kernels/morton.py::morton64_pallas (body
//   _morton_kernel). The TPU kernel cut the points into (bn, dim) VMEM
//   blocks and unrolled bits x dim shift/or steps over each block; here
//   one thread encodes one point.
// Bound on this card: bytes. Per point it reads dim floats and writes two
//   int64 lanes (12 + 16 bytes at dim 3) and does 7 operations per
//   dimension to quantize plus three per interleaved bit, 210 at dim 3:
//   2^20 points move 29.4 MB (8.8 us at 3.35 TB/s) against 2.2e8
//   operations (3.3 us at 67 T/s).
// Design: one thread per point, 256 per block; the scene bounds are read
//   through the read-only cache (every thread reads the same address).
//   The quantization is the reference's, operation for operation:
//   (c - lo) / max(hi - lo, 1e-30) * scale with IEEE division and
//   multiplication, clamped to [0, scale], truncated toward zero; bit j of
//   dimension k goes to position j * dim + k, positions >= 64 dropped.
//   The dimension is a runtime loop (any dim), and nothing is staged:
//   each point's floats are read once. Vector loads of several points per
//   thread are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void morton_kernel(const float* __restrict__ coords,
                              const float* __restrict__ scene_lo,
                              const float* __restrict__ scene_hi, int n,
                              int dim, int bits, float scale,
                              long long* __restrict__ out_hi,
                              long long* __restrict__ out_lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* c = coords + static_cast<long long>(i) * dim;
  unsigned hi = 0u, lo = 0u;
  for (int k = 0; k < dim; ++k) {
    const float l = __ldg(scene_lo + k);
    const float extent = max_nan(__fsub_rn(__ldg(scene_hi + k), l), 1e-30f);
    const float x = __fmul_rn(__fdiv_rn(__fsub_rn(c[k], l), extent), scale);
    const unsigned q = __float2uint_rz(fminf(fmaxf(x, 0.0f), scale));
    for (int j = 0; j < bits; ++j) {
      const int p = j * dim + k;
      if (p >= 64) break;
      const unsigned bit = (q >> j) & 1u;
      if (p < 32) {
        lo |= bit << p;
      } else {
        hi |= bit << (p - 32);
      }
    }
  }
  out_hi[i] = static_cast<long long>(hi);
  out_lo[i] = static_cast<long long>(lo);
}

}  // namespace

// coords (n, dim) float32 contiguous, scene_lo / scene_hi (dim,) float32;
// out_hi / out_lo (n,) int64, each holding a uint32 value.
REPRO_EXPORT int morton64_launch(const void* coords, const void* scene_lo,
                                 const void* scene_hi, int n, int dim,
                                 int bits, void* out_hi, void* out_lo,
                                 void* stream) {
  if (n < 1 || dim < 1 || bits < 0 || bits > 21) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = static_cast<float>((1u << bits) - 1u);
  const int blocks = (n + kThreads - 1) / kThreads;
  morton_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(scene_lo),
      static_cast<const float*>(scene_hi), n, dim, bits, scale,
      static_cast<long long*>(out_hi), static_cast<long long*>(out_lo));
  return static_cast<int>(cudaGetLastError());
}
