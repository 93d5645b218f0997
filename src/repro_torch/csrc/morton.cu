// Morton codes: each point quantized to `bits` per dimension inside the
// scene bounds, its bits interleaved into one code. Two entries:
//   * morton64_launch: the stand-alone op, 64-bit codes of the caller's
//     points in the caller's scene, as two int64 lanes that each hold an
//     unsigned 32-bit half (hi, lo), the convention of
//     repro_torch.core.morton;
//   * morton_key_launch: the LBVH build's step, from the leaf boxes: the
//     centroids 0.5 * (lo + hi), their scene (min and max), and one int64
//     sort key a leaf, the signed image of code ^ 2^63 (32- or 64-bit
//     codes), whose signed order is the codes' unsigned order.
//
// Replaces: src/repro/kernels/morton.py::morton64_pallas (body
//   _morton_kernel), and in the build the XLA ops of
//   src/repro/core/morton.py (quantize, _interleave) and the centroids and
//   scene bounds of src/repro/core/lbvh.py::_build_impl. The TPU kernel
//   cut the points into (bn, dim) VMEM blocks and unrolled bits x dim
//   shift/or steps over each block.
// Bound on this card: bytes. The op reads dim floats a point and writes
//   two int64 lanes (12 + 16 bytes at dim 3): 2^20 points move 29.4 MB,
//   8.8 us at 3.35 TB/s. The build's step reads two boxes' floats and
//   writes one key (24 + 8 bytes at dim 3), 10.0 us, plus the scene pass,
//   which reads the boxes once more (partials of the min and max, one
//   block a slice of the leaves) and its final reduction.
// Design:
//   * dim and bits are template parameters for dims 1-6 (both widths), so
//     every loop unrolls; a generic instance takes any other dim;
//   * the interleave spreads each quantized coordinate by shifts and
//     masks: groups of S bits, S halving from the first power of two >=
//     bits, the upper half of each group moving up by S (dim - 1) at each
//     step (5 steps at 21 bits), then one shift by the dimension's index;
//     the masks are compile-time constants;
//   * one point a thread in the op and the key kernel: scalar loads, which
//     a warp reads as one contiguous run (four points a thread with 16-byte
//     loads ran the op 1.7x slower on an H100 SXM at 700 W); the scene pass
//     takes four a thread with 16-byte loads (scripts/build_variants.py
//     times these);
//   * the build's step is three launches in one C call: the scene pass
//     (partial min / max per block), one block that reduces the partials
//     to the scene, and the key kernel.
//   The quantization is the reference's, operation for operation: (c -
//   lo) / max(hi - lo, 1e-30) * scale with IEEE subtraction, division and
//   multiplication (no reciprocal, no contraction: --fmad=false), clamped
//   to [0, scale], truncated toward zero (a NaN gives 0, as the twin's
//   conversion leaves 0 in every bit it reads); bit j of dimension k goes
//   to position j * dim + k, positions past the code's width dropped. The
//   centroid is __fadd_rn then __fmul_rn by 0.5, as the twin. The scene's
//   min and max propagate NaN as torch.amin / amax; their choice between
//   -0 and +0 can differ from torch's, which changes no code (c - lo and hi
//   - lo do not depend on the sign of a zero lo or hi except at c = +-0,
//   which quantizes to 0 either way).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// points a thread in the templated kernels (scripts/build_variants.py
// times the others): one, with scalar loads that a warp reads as one
// contiguous run, for the op and the key; four, with 16-byte loads, for the
// scene pass
constexpr int kOpPoints = 1;
constexpr int kKeyPoints = 1;
constexpr int kScenePoints = 4;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kSignBit = 1ull << 63;

// core.morton.bits_per_dim
__host__ __device__ constexpr int bits_per_dim(int dim, int total) {
  return total == 32 ? (32 / dim > 1 ? 32 / dim : 1)
                     : dim <= 6 ? (64 / dim < 21 ? 64 / dim : 21) : 64 / dim;
}

__host__ __device__ constexpr int ceil_pow2(int b) {
  int s = 1;
  while (s < b) s <<= 1;
  return s;
}

// the bits kept after the spread step with groups of s bits: bit j sits
// at (j / s) * s * dim + j % s
__host__ __device__ constexpr unsigned long long spread_mask(int dim, int bits,
                                                             int s) {
  unsigned long long m = 0;
  for (int j = 0; j < bits; ++j) {
    const int pos = (j / s) * s * dim + j % s;
    if (pos < 64) m |= 1ull << pos;
  }
  return m;
}

template <int DIM, int BITS, int S>
__device__ __forceinline__ unsigned long long spread_from(
    unsigned long long x) {
  if constexpr (S == 0) {
    return x;
  } else {
    constexpr unsigned long long kMask = spread_mask(DIM, BITS, S);
    x = (x | (x << (S * (DIM - 1)))) & kMask;
    return spread_from<DIM, BITS, S / 2>(x);
  }
}

// bit j of q to bit j * DIM
template <int DIM, int BITS>
__device__ __forceinline__ unsigned long long spread(unsigned q) {
  if constexpr (DIM == 1) {
    return q;
  } else {
    return spread_from<DIM, BITS, ceil_pow2(BITS) / 2>(q);
  }
}

// the reference's quantization of one coordinate
__device__ __forceinline__ unsigned quantize(float c, float lo, float extent,
                                             float scale) {
  const float x = __fmul_rn(__fdiv_rn(__fsub_rn(c, lo), extent), scale);
  return __float2uint_rz(fminf(fmaxf(x, 0.0f), scale));
}

__device__ __forceinline__ float extent_of(float lo, float hi) {
  return max_nan(__fsub_rn(hi, lo), 1e-30f);
}

template <int DIM, int TOTAL>
__device__ __forceinline__ unsigned long long encode(const float* c,
                                                     const float (&lo)[DIM],
                                                     const float (&ext)[DIM],
                                                     float scale) {
  constexpr int kBits = bits_per_dim(DIM, TOTAL);
  unsigned long long code = 0;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    code |= spread<DIM, kBits>(quantize(c[k], lo[k], ext[k], scale)) << k;
  }
  return code;
}

// the P points [first, first + P) of a (n, DIM) array, 16-byte loads when
// all of them are there, P * DIM is a multiple of 4 and the array is
// 16-byte aligned; returns how many are there
template <int DIM, int P>
__device__ __forceinline__ int load_points(const float* __restrict__ a,
                                           long long first, int n, bool vec,
                                           float (&v)[P * DIM]) {
  const int m = n - first < P ? static_cast<int>(n - first) : P;
  const float* p = a + first * DIM;
  if ((P * DIM) % 4 == 0 && vec && m == P) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int t = 0; t < P * DIM / 4; ++t) {
      const float4 f = __ldg(q + t);
      v[4 * t] = f.x;
      v[4 * t + 1] = f.y;
      v[4 * t + 2] = f.z;
      v[4 * t + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < P * DIM; ++t) {
      v[t] = t < m * DIM ? __ldg(p + t) : 0.0f;
    }
  }
  return m;
}

// the centroids of P boxes, in place in lo: 0.5 * (lo + hi)
template <int DIM, int P>
__device__ __forceinline__ void centroids(float (&lo)[P * DIM],
                                          const float (&hi)[P * DIM]) {
#pragma unroll
  for (int t = 0; t < P * DIM; ++t) {
    lo[t] = __fmul_rn(0.5f, __fadd_rn(lo[t], hi[t]));
  }
}

// out[first + p] = v[p] for the m values there, as 16-byte stores when
// all P are and P is even (the outputs are fresh, 256-byte aligned tensors)
template <int P>
__device__ __forceinline__ void store_points(long long* __restrict__ out,
                                             long long first, int m,
                                             const long long (&v)[P]) {
  if (P % 2 == 0 && m == P) {
    auto* o = reinterpret_cast<longlong2*>(out + first);
#pragma unroll
    for (int p = 0; p + 1 < P; p += 2) {
      o[p / 2] = make_longlong2(v[p], v[p + 1]);
    }
  } else {
    for (int p = 0; p < m; ++p) out[first + p] = v[p];
  }
}

// min and max of (mn, mx) over the block, NaN propagating; every thread
// gets them. All kThreads threads call it.
__device__ __forceinline__ void block_minmax(float& mn, float& mx) {
  __shared__ float s_mn[kWarps], s_mx[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min_nan(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  __syncthreads();   // the previous call's readers are done
  if ((threadIdx.x & 31) == 0) {
    s_mn[threadIdx.x >> 5] = mn;
    s_mx[threadIdx.x >> 5] = mx;
  }
  __syncthreads();
  mn = s_mn[0];
  mx = s_mx[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    mn = min_nan(mn, s_mn[w]);
    mx = max_nan(mx, s_mx[w]);
  }
}

// ---------------------------------------------------------------------------
// the stand-alone op: (hi, lo) lanes of the caller's points
// ---------------------------------------------------------------------------

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    lanes_kernel(const float* __restrict__ coords,
                 const float* __restrict__ scene_lo,
                 const float* __restrict__ scene_hi, int n, float scale,
                 bool vec, long long* __restrict__ out_hi,
                 long long* __restrict__ out_lo) {
  constexpr int P = kOpPoints;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
  if (first >= n) return;
  float lo[DIM], ext[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    lo[k] = __ldg(scene_lo + k);
    ext[k] = extent_of(lo[k], __ldg(scene_hi + k));
  }
  float v[P * DIM];
  const int m = load_points<DIM, P>(coords, first, n, vec, v);
  long long h[P], l[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const unsigned long long code = encode<DIM, 64>(v + p * DIM, lo, ext, scale);
    h[p] = static_cast<long long>(code >> 32);
    l[p] = static_cast<long long>(code & 0xffffffffull);
  }
  store_points(out_hi, first, m, h);
  store_points(out_lo, first, m, l);
}

// any dim and bits: one point a thread, the bit loop at run time
__global__ void __launch_bounds__(kThreads)
    lanes_generic(const float* __restrict__ coords,
                  const float* __restrict__ scene_lo,
                  const float* __restrict__ scene_hi, int n, int dim,
                  int bits, float scale, long long* __restrict__ out_hi,
                  long long* __restrict__ out_lo) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  unsigned long long code = 0;
  for (int k = 0; k < dim; ++k) {
    const float lo = __ldg(scene_lo + k);
    const unsigned q = quantize(__ldg(coords + i * dim + k), lo,
                                extent_of(lo, __ldg(scene_hi + k)), scale);
    for (int j = 0; j < bits && j * dim + k < 64; ++j) {
      code |= static_cast<unsigned long long>((q >> j) & 1u) << (j * dim + k);
    }
  }
  out_hi[i] = static_cast<long long>(code >> 32);
  out_lo[i] = static_cast<long long>(code & 0xffffffffull);
}

// ---------------------------------------------------------------------------
// the build's step: scene partials, then one sort key a leaf
// ---------------------------------------------------------------------------

// partial scene of the centroids: block b writes (min, max) of its
// slice's centroids per dimension at parts[b * 2 * dim]
template <int DIM>
__global__ void __launch_bounds__(kThreads)
    scene_kernel(const float* __restrict__ box_lo,
                 const float* __restrict__ box_hi, int n, bool vec,
                 float* __restrict__ parts) {
  float mn[DIM], mx[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    mn[k] = INFINITY;
    mx[k] = -INFINITY;
  }
  constexpr int P = kScenePoints;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * P;
  for (long long first =
           (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
       first < n; first += stride) {
    float a[P * DIM], b[P * DIM];
    const int m = load_points<DIM, P>(box_lo, first, n, vec, a);
    load_points<DIM, P>(box_hi, first, n, vec, b);
    centroids<DIM, P>(a, b);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < m) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          mn[k] = min_nan(mn[k], a[p * DIM + k]);
          mx[k] = max_nan(mx[k], a[p * DIM + k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    block_minmax(mn[k], mx[k]);
    if (threadIdx.x == 0) {
      parts[blockIdx.x * 2 * DIM + k] = mn[k];
      parts[blockIdx.x * 2 * DIM + DIM + k] = mx[k];
    }
  }
}

// the scene of dimension k from the partials, one partial a thread
__device__ __forceinline__ void scene_of(const float* __restrict__ parts,
                                         int nparts, int dim, int k,
                                         float& lo, float& hi) {
  lo = INFINITY;
  hi = -INFINITY;
  for (int p = threadIdx.x; p < nparts; p += kThreads) {
    lo = min_nan(lo, parts[p * 2 * dim + k]);
    hi = max_nan(hi, parts[p * 2 * dim + dim + k]);
  }
  block_minmax(lo, hi);
}

// one block: the scene (lo, extent) of every dimension from the partials,
// at scene[2 k], scene[2 k + 1]
__global__ void __launch_bounds__(kThreads)
    scene_final(const float* __restrict__ parts, int nparts, int dim,
                float* __restrict__ scene) {
  for (int k = 0; k < dim; ++k) {
    float lo, hi;
    scene_of(parts, nparts, dim, k, lo, hi);
    if (threadIdx.x == 0) {
      scene[2 * k] = lo;
      scene[2 * k + 1] = extent_of(lo, hi);
    }
  }
}

template <int DIM, int TOTAL>
__global__ void __launch_bounds__(kThreads)
    key_kernel(const float* __restrict__ box_lo,
               const float* __restrict__ box_hi,
               const float* __restrict__ scene, int n, float scale, bool vec,
               long long* __restrict__ key) {
  constexpr int P = kKeyPoints;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * P;
  if (first >= n) return;
  float lo[DIM], ext[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    lo[k] = __ldg(scene + 2 * k);
    ext[k] = __ldg(scene + 2 * k + 1);
  }
  float a[P * DIM], b[P * DIM];
  const int m = load_points<DIM, P>(box_lo, first, n, vec, a);
  load_points<DIM, P>(box_hi, first, n, vec, b);
  centroids<DIM, P>(a, b);
  long long out[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p] = static_cast<long long>(
        encode<DIM, TOTAL>(a + p * DIM, lo, ext, scale) ^ kSignBit);
  }
  store_points(key, first, m, out);
}

// any dim: the scene partials one dimension after another
__global__ void __launch_bounds__(kThreads)
    scene_generic(const float* __restrict__ box_lo,
                  const float* __restrict__ box_hi, int n, int dim,
                  float* __restrict__ parts) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int k = 0; k < dim; ++k) {
    float mn = INFINITY, mx = -INFINITY;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < n; i += stride) {
      const float c = __fmul_rn(0.5f, __fadd_rn(__ldg(box_lo + i * dim + k),
                                                __ldg(box_hi + i * dim + k)));
      mn = min_nan(mn, c);
      mx = max_nan(mx, c);
    }
    block_minmax(mn, mx);
    if (threadIdx.x == 0) {
      parts[blockIdx.x * 2 * dim + k] = mn;
      parts[blockIdx.x * 2 * dim + dim + k] = mx;
    }
  }
}

// any dim and width: one point a thread
__global__ void __launch_bounds__(kThreads)
    key_generic(const float* __restrict__ box_lo,
                const float* __restrict__ box_hi,
                const float* __restrict__ scene, int n, int dim, int bits,
                int total, float scale, long long* __restrict__ key) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  unsigned long long code = 0;
  for (int k = 0; k < dim; ++k) {
    const float c = __fmul_rn(0.5f, __fadd_rn(__ldg(box_lo + i * dim + k),
                                              __ldg(box_hi + i * dim + k)));
    const unsigned q = quantize(c, __ldg(scene + 2 * k),
                                __ldg(scene + 2 * k + 1), scale);
    for (int j = 0; j < bits && j * dim + k < total; ++j) {
      code |= static_cast<unsigned long long>((q >> j) & 1u) << (j * dim + k);
    }
  }
  key[i] = static_cast<long long>(code ^ kSignBit);
}

// float32 scale of the grid, (float)(2^bits - 1) rounded to nearest as the
// twin's torch.tensor(..., float32): 2^32 at bits = 32
float scale_of(int bits) {
  return static_cast<float>(static_cast<double>((1ull << bits) - 1ull));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int blocks_of(long long items) {
  return static_cast<int>((items + kThreads - 1) / kThreads);
}

template <int DIM>
void launch_lanes(const float* c, const float* lo, const float* hi, int n,
                  float scale, long long* oh, long long* ol, cudaStream_t s) {
  lanes_kernel<DIM><<<blocks_of((n + kOpPoints - 1) / kOpPoints), kThreads, 0,
                      s>>>(c, lo, hi, n, scale, aligned16(c), oh, ol);
}

// the scene pass and the key kernel of one dim (the scene's final
// reduction between them)
template <int DIM, int TOTAL>
void launch_key(const float* lo, const float* hi, int n, int nparts,
                float* parts, float* scene, long long* key, cudaStream_t s) {
  const bool vec = aligned16(lo) && aligned16(hi);
  scene_kernel<DIM><<<nparts, kThreads, 0, s>>>(lo, hi, n, vec, parts);
  scene_final<<<1, kThreads, 0, s>>>(parts, nparts, DIM, scene);
  key_kernel<DIM, TOTAL>
      <<<blocks_of((n + kKeyPoints - 1) / kKeyPoints), kThreads, 0, s>>>(
          lo, hi, scene, n, scale_of(bits_per_dim(DIM, TOTAL)), vec, key);
}

template <int TOTAL>
bool launch_key_dim(const float* lo, const float* hi, int n, int dim,
                    int nparts, float* parts, float* scene, long long* key,
                    cudaStream_t s) {
  switch (dim) {
    case 1: launch_key<1, TOTAL>(lo, hi, n, nparts, parts, scene, key, s); return true;
    case 2: launch_key<2, TOTAL>(lo, hi, n, nparts, parts, scene, key, s); return true;
    case 3: launch_key<3, TOTAL>(lo, hi, n, nparts, parts, scene, key, s); return true;
    case 4: launch_key<4, TOTAL>(lo, hi, n, nparts, parts, scene, key, s); return true;
    case 5: launch_key<5, TOTAL>(lo, hi, n, nparts, parts, scene, key, s); return true;
    case 6: launch_key<6, TOTAL>(lo, hi, n, nparts, parts, scene, key, s); return true;
    default: return false;
  }
}

}  // namespace

// most partials of the build's scene pass: the wrapper's scratch holds
// 2 * dim * (kMaxParts + 1) floats, the partials and then the scene
constexpr int kMaxParts = 256;

// coords (n, dim) float32 contiguous, scene_lo / scene_hi (dim,) float32;
// out_hi / out_lo (n,) int64, each holding a uint32 value; bits is
// bits_per_dim(dim, 64)
REPRO_EXPORT int morton64_launch(const void* coords, const void* scene_lo,
                                 const void* scene_hi, int n, int dim,
                                 int bits, void* out_hi, void* out_lo,
                                 void* stream) {
  if (n < 1 || dim < 1 || bits != bits_per_dim(dim, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(coords);
  auto lo = static_cast<const float*>(scene_lo);
  auto hi = static_cast<const float*>(scene_hi);
  auto oh = static_cast<long long*>(out_hi);
  auto ol = static_cast<long long*>(out_lo);
  const float scale = scale_of(bits);
  switch (dim) {
    case 1: launch_lanes<1>(c, lo, hi, n, scale, oh, ol, s); break;
    case 2: launch_lanes<2>(c, lo, hi, n, scale, oh, ol, s); break;
    case 3: launch_lanes<3>(c, lo, hi, n, scale, oh, ol, s); break;
    case 4: launch_lanes<4>(c, lo, hi, n, scale, oh, ol, s); break;
    case 5: launch_lanes<5>(c, lo, hi, n, scale, oh, ol, s); break;
    case 6: launch_lanes<6>(c, lo, hi, n, scale, oh, ol, s); break;
    default:
      lanes_generic<<<blocks_of(n), kThreads, 0, s>>>(c, lo, hi, n, dim, bits,
                                                      scale, oh, ol);
  }
  return static_cast<int>(cudaGetLastError());
}

// box_lo / box_hi (n, dim) float32 contiguous (the leaf boxes in the
// caller's order); total_bits 32 or 64; parts: scratch of 2 * dim *
// (kMaxParts + 1) floats; key (n,) int64: code ^ 2^63 as a signed integer
REPRO_EXPORT int morton_key_launch(const void* box_lo, const void* box_hi,
                                   int n, int dim, int total_bits,
                                   void* parts, void* key, void* stream) {
  if (n < 1 || dim < 1 || (total_bits != 32 && total_bits != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto lo = static_cast<const float*>(box_lo);
  auto hi = static_cast<const float*>(box_hi);
  auto pt = static_cast<float*>(parts);
  auto sc = pt + 2 * dim * kMaxParts;
  auto k = static_cast<long long*>(key);
  int nparts = blocks_of((static_cast<long long>(n) + kScenePoints - 1) /
                         kScenePoints);
  if (nparts > kMaxParts) nparts = kMaxParts;
  const bool done =
      total_bits == 64
          ? launch_key_dim<64>(lo, hi, n, dim, nparts, pt, sc, k, s)
          : launch_key_dim<32>(lo, hi, n, dim, nparts, pt, sc, k, s);
  if (!done) {
    const int bits = bits_per_dim(dim, total_bits);
    scene_generic<<<nparts, kThreads, 0, s>>>(lo, hi, n, dim, pt);
    scene_final<<<1, kThreads, 0, s>>>(pt, nparts, dim, sc);
    key_generic<<<blocks_of(n), kThreads, 0, s>>>(lo, hi, sc, n, dim, bits,
                                                  total_bits, scale_of(bits),
                                                  k);
  }
  return static_cast<int>(cudaGetLastError());
}
