// Nearest ray-box hit over a flat box soup: for each ray the smallest
// entry parameter t >= 0 over all B boxes and the first box reaching it,
// (inf, -1) when no box is hit.
//
// Replaces: src/repro/kernels/ray_box.py::ray_box_nearest_pallas (body
//   _ray_box_kernel). The TPU kernel swept (br, bb) panels of rays x boxes
//   through VMEM with a running (t, idx) pair per ray carried across the
//   sequential box axis of its grid; here each thread holds rays and
//   their running best in registers, and blocks stream boxes through
//   shared memory, a tile at a time.
// Bound on this card: operations. R * B slab tests of 8 * dim + 4
//   operations each, against R * dim * 8 + B * dim * 8 + R * 8 bytes; in
//   issued instructions about 28 per 3-D pair (no pair has an FMA).
// Design, dim = 3 (ray_box3_kernel<kRays3>, T = 4 rays a thread):
//   each thread holds T rays (origin, 1/d, the zero-component mask, the
//   running (t, idx)), so each box read from shared memory feeds T slab
//   tests; four boxes' lo and hi are six 16-byte shared loads. One
//   thread stages tiles of kTile3 boxes by 1-D bulk copies into a ring of
//   two stages on mbarriers, so the next tile lands while this one is
//   tested; a ragged last tile is loaded plainly, padded with NaN boxes
//   (a NaN box is never hit). Blocks split the box
//   axis so that R = 2^17 rays fill 132 SMs; each ray's best over its
//   range goes to a 64-bit key (bits of t) << 32 | index, merged by
//   atomicMin: t >= +0, whose bits order as unsigned ints, so the minimum
//   key is the smallest t and on equal t the lowest index, the twin's
//   ascending strict-< sweep. A second kernel, the decode pass
//   (ray_box_decode), writes (t, idx), (inf, -1) where no key was set. The slab test keeps geometry.ray_box's
//   arithmetic ((l - o) * inv, no FMA); its four inner min / max per axis
//   are PTX min.NaN / max.NaN (one instruction each), which differ from
//   the twin's only in NaN payloads and signed zeros: neither reaches
//   the output, since t = max(tmin, 0) (a NaN t is no hit) and
//   tmax >= t reads no sign of zero.
// Design, other dims (ray_box_kernel): one thread per ray with its origin
//   and 1/d in registers; the block stages kTile boxes' lo/hi in shared
//   memory (a broadcast read) and tests them in ascending order with a
//   strict < update, which keeps the first box on equal t.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 128;
constexpr int kTile = 256;

__global__ void ray_box_kernel(const float* __restrict__ origins,
                               const float* __restrict__ directions,
                               const float* __restrict__ box_lo,
                               const float* __restrict__ box_hi, int r, int b,
                               int dim, float* __restrict__ t_out,
                               int* __restrict__ i_out) {
  extern __shared__ float tile[];  // lo (kTile, dim), then hi (kTile, dim)
  float* s_lo = tile;
  float* s_hi = tile + kTile * dim;
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < r;
  float o[kMaxDim], inv[kMaxDim];
  const unsigned zero =
      live ? load_ray(origins + static_cast<long long>(ray) * dim,
                      directions + static_cast<long long>(ray) * dim, dim, o,
                      inv)
           : 0u;
  float best = INFINITY;
  int best_i = -1;
  for (int base = 0; base < b; base += kTile) {
    const int nt = min(kTile, b - base);
    __syncthreads();
    for (int k = threadIdx.x; k < nt * dim; k += blockDim.x) {
      s_lo[k] = box_lo[static_cast<long long>(base) * dim + k];
      s_hi[k] = box_hi[static_cast<long long>(base) * dim + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nt; ++j) {
      float te;
      if (ray_slab(o, inv, zero, s_lo + j * dim, s_hi + j * dim, dim,
                   LoadPlain(), te) &&
          te < best) {
        best = te;
        best_i = base + j;
      }
    }
  }
  if (live) {
    t_out[ray] = best;
    i_out[ray] = best_i;
  }
}

// --- dim = 3 ------------------------------------------------------------

constexpr int kThreads3 = 128;
constexpr int kTile3 = 256;   // boxes per stage, a multiple of 4
constexpr int kStages = 2;    // stages of the ring
constexpr int kRays3 = 4;     // rays per thread
constexpr unsigned long long kNoHit = 0x7F8000007FFFFFFFull;  // (inf, INT_MAX)

__device__ __forceinline__ float min_ptx(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_ptx(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// boxes [base, base + 4 * groups) from a stage (lo, hi: (4 * groups, 3))
// against the thread's T rays; kZero: some ray of the block has a zero
// direction component
template <int T, bool kZero>
__device__ __forceinline__ void sweep3(const float* s_lo, const float* s_hi,
                                       int groups, int base,
                                       const float (&o)[T][3],
                                       const float (&inv)[T][3],
                                       const unsigned (&zero)[T],
                                       float (&best)[T], int (&best_i)[T]) {
  const float4* L = reinterpret_cast<const float4*>(s_lo);
  const float4* H = reinterpret_cast<const float4*>(s_hi);
  for (int g = 0; g < groups; ++g) {
    const float4 l0 = L[3 * g], l1 = L[3 * g + 1], l2 = L[3 * g + 2];
    const float4 h0 = H[3 * g], h1 = H[3 * g + 1], h2 = H[3 * g + 2];
    const float lo[4][3] = {{l0.x, l0.y, l0.z}, {l0.w, l1.x, l1.y},
                            {l1.z, l1.w, l2.x}, {l2.y, l2.z, l2.w}};
    const float hi[4][3] = {{h0.x, h0.y, h0.z}, {h0.w, h1.x, h1.y},
                            {h1.z, h1.w, h2.x}, {h2.y, h2.z, h2.w}};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < T; ++k) {
        float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float lo_d, hi_d;
          if (kZero && ((zero[k] >> c) & 1u)) {
            const bool inside = o[k][c] >= lo[j][c] && o[k][c] <= hi[j][c];
            lo_d = inside ? -INFINITY : INFINITY;
            hi_d = inside ? INFINITY : -INFINITY;
          } else {
            const float t0 = (lo[j][c] - o[k][c]) * inv[k][c];
            const float t1 = (hi[j][c] - o[k][c]) * inv[k][c];
            lo_d = min_ptx(t0, t1);
            hi_d = max_ptx(t0, t1);
          }
          // the first axis: max(-inf, lo_d) is lo_d, min(inf, hi_d) hi_d
          tmin = c == 0 ? lo_d : max_ptx(tmin, lo_d);
          tmax = c == 0 ? hi_d : min_ptx(tmax, hi_d);
        }
        const float te = max_nan(tmin, 0.0f);
        if (tmax >= te && te < best[k]) {
          best[k] = te;
          best_i[k] = base + 4 * g + j;
        }
      }
    }
  }
}

// grid (ray blocks, splits): block (x, y) takes rays [x * 128 T, ...)
// against boxes [y * chunk, (y + 1) * chunk) and merges into keys
template <int T>
__global__ void __launch_bounds__(kThreads3)
    ray_box3_kernel(const float* __restrict__ origins,
                    const float* __restrict__ directions,
                    const float* __restrict__ box_lo,
                    const float* __restrict__ box_hi, int r, int b, int chunk,
                    unsigned long long* __restrict__ keys) {
  constexpr int S = kStages;
  extern __shared__ __align__(16) float ring[];  // S x (lo, hi) (kTile3, 3)
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + S * 6 * kTile3);
  const int tid = threadIdx.x;
  float o[T][3], inv[T][3], best[T];
  unsigned zero[T];
  int best_i[T], ray[T];
  unsigned any_zero = 0;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    ray[k] = blockIdx.x * (kThreads3 * T) + k * kThreads3 + tid;
    const long long ro = static_cast<long long>(min(ray[k], r - 1)) * 3;
    zero[k] = load_ray(origins + ro, directions + ro, 3, o[k], inv[k]);
    any_zero |= zero[k];
    best[k] = INFINITY;
    best_i[k] = -1;
  }
  const bool slow = __syncthreads_or(any_zero != 0u);
  const int b0 = blockIdx.y * chunk;
  const int count = max(0, min(b, b0 + chunk) - b0);
  const int full = count / kTile3;
  const int tail = count - full * kTile3;
  constexpr uint32_t kBytes = kTile3 * 3 * sizeof(float);
  auto issue = [&](int s, int tile) {
    const uint32_t bar = hopper::smem_addr(bars + s);
    const long long at = (static_cast<long long>(b0) + tile * kTile3) * 3;
    hopper::mbar_expect_tx(bar, 2 * kBytes);
    hopper::bulk_load(hopper::smem_addr(ring + s * 6 * kTile3), box_lo + at,
                      kBytes, bar);
    hopper::bulk_load(hopper::smem_addr(ring + s * 6 * kTile3 + 3 * kTile3),
                      box_hi + at, kBytes, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) hopper::mbar_init(hopper::smem_addr(bars + s), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    // rolled: unrolled, this loop faulted at three stages and six or
    // eight rays a thread (a hang that the 4 s trap ended, or an illegal
    // address), and rolled it ran right (PERF.md, "the ring fault")
#pragma unroll 1
    for (int s = 0; s < S && s < full; ++s) issue(s, s);
  }
  for (int t = 0; t < full; ++t) {
    const int s = t % S;
    hopper::mbar_wait(hopper::smem_addr(bars + s), (t / S) & 1);
    const float* s_lo = ring + s * 6 * kTile3;
    const int base = b0 + t * kTile3;
    if (slow) {
      sweep3<T, true>(s_lo, s_lo + 3 * kTile3, kTile3 / 4, base, o, inv, zero,
                      best, best_i);
    } else {
      sweep3<T, false>(s_lo, s_lo + 3 * kTile3, kTile3 / 4, base, o, inv,
                       zero, best, best_i);
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && t + S < full) {
      hopper::fence_proxy_async();
      issue(s, t + S);
    }
  }
  if (tail > 0) {
    // every copy has landed and been read: stage 0 takes the tail plainly
    float* s_lo = ring;
    float* s_hi = ring + 3 * kTile3;
    const int padded = (tail + 3) & ~3;
    const long long at = (static_cast<long long>(b0) + full * kTile3) * 3;
    for (int k = tid; k < padded * 3; k += kThreads3) {
      const bool in = k < tail * 3;
      s_lo[k] = in ? box_lo[at + k] : NAN;
      s_hi[k] = in ? box_hi[at + k] : NAN;
    }
    __syncthreads();
    const int base = b0 + full * kTile3;
    if (slow) {
      sweep3<T, true>(s_lo, s_hi, padded / 4, base, o, inv, zero, best, best_i);
    } else {
      sweep3<T, false>(s_lo, s_hi, padded / 4, base, o, inv, zero, best,
                       best_i);
    }
  }
#pragma unroll
  for (int k = 0; k < T; ++k) {
    if (ray[k] < r && best_i[k] >= 0) {
      atomicMin(keys + ray[k],
                static_cast<unsigned long long>(__float_as_uint(best[k])) << 32 |
                    static_cast<unsigned>(best_i[k]));
    }
  }
}

__global__ void ray_box_decode(const unsigned long long* __restrict__ keys,
                               int r, float* __restrict__ t_out,
                               int* __restrict__ i_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const unsigned long long k = keys[i];
  const bool miss = k == kNoHit;
  t_out[i] = miss ? INFINITY : __uint_as_float(static_cast<unsigned>(k >> 32));
  i_out[i] = miss ? -1 : static_cast<int>(k & 0xFFFFFFFFull);
}

template <int T>
void launch3(const float* o, const float* d, const float* lo, const float* hi,
             int r, int b, int splits, int chunk, unsigned long long* keys,
             cudaStream_t stream) {
  const dim3 grid((r + kThreads3 * T - 1) / (kThreads3 * T), splits);
  const size_t shmem =
      kStages * (6 * kTile3 * sizeof(float) + sizeof(uint64_t));
  ray_box3_kernel<T><<<grid, kThreads3, shmem, stream>>>(o, d, lo, hi, r, b,
                                                         chunk, keys);
}

}  // namespace

// origins / directions (r, dim), box_lo / box_hi (b, dim), all float32
// and contiguous; t_out (r,) float32, i_out (r,) int32. keys: null for
// the generic kernel (any dim), else the dim = 3 kernel's (r,) uint64
// merge keys, filled with (inf, INT_MAX), with the box axis cut into
// `splits` ranges of `chunk` boxes (a multiple of 256); box_lo and box_hi
// 16-byte aligned. The dim = 3 call launches the slab-test kernel, then
// the decode pass.
REPRO_EXPORT int ray_box_nearest_launch(const void* origins,
                                        const void* directions,
                                        const void* box_lo, const void* box_hi,
                                        int r, int b, int dim, void* t_out,
                                        void* i_out, void* keys,
                                        int splits, int chunk, void* stream) {
  if (dim < 1 || dim > kMaxDim || r < 1 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const float*>(origins);
  auto d = static_cast<const float*>(directions);
  auto lo = static_cast<const float*>(box_lo);
  auto hi = static_cast<const float*>(box_hi);
  if (keys == nullptr) {
    const int blocks = (r + kThreads - 1) / kThreads;
    const size_t shmem = 2 * sizeof(float) * kTile * dim;
    ray_box_kernel<<<blocks, kThreads, shmem, st>>>(
        o, d, lo, hi, r, b, dim, static_cast<float*>(t_out),
        static_cast<int*>(i_out));
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(lo) |
                        reinterpret_cast<uintptr_t>(hi)) % 16 == 0;
  if (dim != 3 || !aligned || splits < 1 || chunk < kTile3 ||
      chunk % kTile3 != 0 || static_cast<long long>(splits) * chunk < b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto k = static_cast<unsigned long long*>(keys);
  launch3<kRays3>(o, d, lo, hi, r, b, splits, chunk, k, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ray_box_decode<<<(r + 255) / 256, 256, 0, st>>>(
      k, r, static_cast<float*>(t_out), static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}
