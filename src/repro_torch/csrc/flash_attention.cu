// Flash attention: causal, sliding-window, GQA online-softmax attention.
// q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D), contiguous, all of one type
// (bfloat16, float16 or float32); o (B, Hq, Sq, D) in that type. Query
// head h reads KV head h / (Hq / Hkv). Query row i sits at position
// i + (Skv - Sq) (right-aligned); key j is visible when j < Skv, j <= the
// row's position (causal) and j > position - window (window > 0).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (body _flash_kernel). The TPU kernel carried each (batch, head,
//   q-block) row state (m, l, acc) in VMEM scratch across the sequential
//   KV axis of its grid and skipped KV blocks that were wholly masked.
//   Here a block owns a query tile, keeps the row states in registers,
//   and a loop over KV tiles takes the place of the grid's KV axis, with
//   the reference's live test per tile (the causal break, the window's
//   skip, the Skv end).
// Bound on this card: operations at the bf16 tensor-core rate. 4 D per
//   visible (query, key) pair (two products of length D), against q, k, v
//   read once and o written once; at B = 4, Hq = 32, Hkv = 4, S = 2048,
//   D = 64 in bf16, causal: 68.7 GFLOP / 989 TFLOP/s = 0.0695 ms, bytes
//   75.5 MB / 3.35 TB/s = 0.0225 ms.
//
// bfloat16 and float16: flash_kernel_tc<T, DH>, the tensor cores.
//   Block: one (batch, query head, query tile); the tiles of a problem
//   launch heaviest first (reverse order), so a causal grid does not end
//   on a wave of short tiles. Consumer warpgroups own 64 query rows each
//   (wgmma's M): three (a 192-row tile) at DH = 64, two (128 rows) at
//   DH = 128. One more warpgroup holds the producer thread that issues
//   the copies; at DH = 64 setmaxnreg gives its registers to the
//   consumers.
//   Copies: TMA through 3-D tensor maps (D, S, B*H), boxes of 64 columns
//   with 128-byte swizzle. Q is loaded once; K and V go through a ring of
//   two 128-key stages with full and empty mbarriers, so loads stay in
//   flight while the consumers compute (a third stage gained nothing).
//   Rows past Skv and columns past D are zero-filled by the copy (zero V
//   rows: no NaN from garbage where p = 0).
//   Head widths: D pads to DH = 64 or 128 (any multiple of 8 up to 128);
//   zero columns leave q.k unchanged and the extra output columns are
//   never stored.
//   Products: S = Q K^T by wgmma m64n128k16 (A = Q, B = K, both from
//   shared memory, K-major), float32 accumulators. O += P V by wgmma
//   m64nDHk16 with A = P in registers (the S accumulator's fragment is
//   the register-A layout) and B = V (MN-major: the transpose bit).
//   Softmax on the accumulator fragment: s is scaled after the product,
//   by scale * log2(e), and the hardware's exp2 (ex2.approx, the fast
//   exp2f) takes the place of expf; row max and sum are a 4-lane
//   shuffle; the element mask applies only on tiles that cross the
//   diagonal, the window edge or Skv; l sums the float32 p.
//   p is rounded to the input type before P V: that is the one departure
//   from the reference's arithmetic, at most u * (the p-weighted mean of
//   |v|) per output, u = 2^-8 (bf16) or 2^-11 (fp16). Every product-add
//   is an explicit __fmaf_rn (the build turns contraction off). The
//   epilogue writes o = acc / max(l, 1e-30) (0 for a row with no visible
//   key) through shared memory with a TMA store, which clips at Sq and D.
//   Tried and slower: issuing a tile's Q K^T beside the previous tile's
//   P V inside each warpgroup. Left on the table: alternating the
//   warpgroups' softmax and products by named barriers, a persistent
//   grid, and one K/V tile shared by the query heads of a GQA group.
//
// float32: flash_kernel_f32<D>, the CUDA cores (tensor cores in float32
//   would mean TF32). Arithmetic as _flash_kernel's: s = (q * scale) . k,
//   masked entries -1e30, m' = max(m, max_j s), alpha = exp(m - m'),
//   p = exp(s - m') masked to 0 after the exp, l' = l alpha + sum_j p,
//   acc' = acc alpha + p . v, every product an fmaf, exp an expf. One
//   block per (batch, query head, 64-row tile), 4 warps of 16 rows; q
//   (scaled), K and V staged in shared memory as float32, each lane
//   scoring 2 keys for 4 rows at a time and accumulating D/32 output
//   columns. D in {16, 32, 64, 96, 112, 128}.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;  // rows per warp
constexpr int kGroup = 4;            // rows scored together
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q (kBQ, D), K (kBK, D + 4: float4 rows, no bank conflicts), V (kBK, D),
  // p (kWarps, kGroup, kBK)
  return sizeof(float) *
         (kBQ * D + kBK * (D + 4) + kBK * D + kWarps * kGroup * kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel_f32(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int hq, int hkv, int sq, int skv, int causal, int window,
                     float scale) {
  constexpr int KS = D + 4;
  constexpr int DT = (D + 31) / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * D;
  float* vs = ks + kBK * KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ps = vs + kBK * D + warp * kGroup * kBK;

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, sq - q0);
  const int off = skv - sq;
  const long long qrow0 = (static_cast<long long>(b) * hq + h) * sq + q0;
  const long long krow0 = (static_cast<long long>(b) * hkv + hk) * skv;

  for (int e = threadIdx.x; e < kBQ * D / 4; e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nq) x = load4(q + (qrow0 + r) * D + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * D + c) = x;
  }

  float m[kRows], l[kRows], acc[kRows][DT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  // the tile's live test, _flash_kernel's, on this tile's real rows
  const int q_first = q0 + off, q_last = q0 + nq - 1 + off;
  for (int j0 = 0; j0 < skv; j0 += kBK) {
    if (causal && j0 > q_last) break;
    if (window > 0 && j0 + kBK - 1 <= q_first - window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBK * D / 4; e += kThreads) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j0 + r < skv) {
        kx = load4(k + (krow0 + j0 + r) * D + c);
        vx = load4(v + (krow0 + j0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(ks + r * KS + c) = kx;
      *reinterpret_cast<float4*>(vs + r * D + c) = vx;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kRows / kGroup; ++g) {
      const int rb = warp * kRows + g * kGroup;  // first row of the group
      float s[kGroup][2];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(ks + lane * KS + c);
        const float4 k1 =
            *reinterpret_cast<const float4*>(ks + (lane + 32) * KS + c);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(qs + (rb + r) * D + c);
          s[r][0] = fmaf(x.x, k0.x, s[r][0]);
          s[r][0] = fmaf(x.y, k0.y, s[r][0]);
          s[r][0] = fmaf(x.z, k0.z, s[r][0]);
          s[r][0] = fmaf(x.w, k0.w, s[r][0]);
          s[r][1] = fmaf(x.x, k1.x, s[r][1]);
          s[r][1] = fmaf(x.y, k1.y, s[r][1]);
          s[r][1] = fmaf(x.z, k1.z, s[r][1]);
          s[r][1] = fmaf(x.w, k1.w, s[r][1]);
        }
      }
      float alpha[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int qpos = q0 + rb + r + off;
        float p[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = j0 + lane + 32 * c;
          const bool ok = kpos < skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          s[r][c] = ok ? s[r][c] : kNegInf;
          p[c] = ok ? 1.f : 0.f;
        }
        const int i = g * kGroup + r;
        const float m_cur = max_nan(m[i], warp_max(max_nan(s[r][0], s[r][1])));
        alpha[r] = expf(m[i] - m_cur);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p[c] = p[c] != 0.f ? expf(s[r][c] - m_cur) : 0.f;
          ps[r * kBK + lane + 32 * c] = p[c];
        }
        l[i] = l[i] * alpha[r] + warp_sum(p[0] + p[1]);
        m[i] = m_cur;
      }
      __syncwarp();
      float pv[kGroup][DT];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
#pragma unroll
        for (int t = 0; t < DT; ++t) pv[r][t] = 0.f;
      }
#pragma unroll 2
      for (int j = 0; j < kBK; j += 4) {
        float4 pr[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          pr[r] = *reinterpret_cast<const float4*>(ps + r * kBK + j);
        }
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          const int d = lane + 32 * t;
          if (D % 32 == 0 || d < D) {
            const float v0 = vs[(j + 0) * D + d], v1 = vs[(j + 1) * D + d];
            const float v2 = vs[(j + 2) * D + d], v3 = vs[(j + 3) * D + d];
#pragma unroll
            for (int r = 0; r < kGroup; ++r) {
              pv[r][t] = fmaf(pr[r].x, v0, pv[r][t]);
              pv[r][t] = fmaf(pr[r].y, v1, pv[r][t]);
              pv[r][t] = fmaf(pr[r].z, v2, pv[r][t]);
              pv[r][t] = fmaf(pr[r].w, v3, pv[r][t]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          const int i = g * kGroup + r;
          acc[i][t] = acc[i][t] * alpha[r] + pv[r][t];
        }
      }
      __syncwarp();  // the next group overwrites ps
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    if (r < nq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int d = lane + 32 * t;
        if (D % 32 == 0 || d < D) o[(qrow0 + r) * D + d] = acc[i][t] / denom;
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t shmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel_f32<D><<<grid, kThreads, shmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, skv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bfloat16 / float16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTileK = 128;    // keys per KV stage
constexpr int kStages = 2;     // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr uint32_t kQBox = 64 * 128;      // bytes: 64 rows x 64 columns
constexpr uint32_t kKBox = kTileK * 128;  // bytes: 128 rows x 64 columns

template <int DH>
struct TcLayout {
  // consumer warpgroups of 64 query rows: three at DH = 64, which
  // setmaxnreg raises from the 128 registers of launch to 160 (65,536 in
  // all with the producer's 24); two at DH = 128, which keep the 168 of
  // launch, because raising them to 240 made ptxas spill. Each choice is
  // the faster in scripts/flash_variants.py (PERF.md).
  static constexpr int kConsumers = DH == 64 ? 3 : 2;
  static constexpr bool kMoveRegs = DH == 64;
  static constexpr int kConsumerRegs = 160;
  static constexpr int kTileQ = 64 * kConsumers;  // query rows per block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kHalves = DH / 64;  // 64-column boxes per row
  // Q as [consumer][half] boxes; K and V as [stage][half]
  static constexpr uint32_t q_bytes = kConsumers * kHalves * kQBox;
  static constexpr uint32_t kv_bytes = kHalves * kKBox;  // one stage of K
  static constexpr uint32_t smem = 1024 + q_bytes + 2 * kStages * kv_bytes;
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error near
// 2^-22; a result below 2^-126 flushes to 0, which no sum here can see
// beside the row maximum's p = 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragments (wgmma m64nN, float32): thread t of a warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 + 8 h, h = 0, 1, and in each
// 8-column block i the columns 8 i + 2 (t % 4) + e, e = 0, 1, at index
// 4 i + 2 h + e.
template <typename T, int DH>
__global__ void __launch_bounds__(TcLayout<DH>::kThreads, 1)
    flash_kernel_tc(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, int hq, int hkv,
                    int sq, int skv, int causal, int window,
                    float scale_log2) {
  using L = TcLayout<DH>;
  constexpr int H = L::kHalves, kConsumers = L::kConsumers;
  constexpr int kTileQ = L::kTileQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // every box region starts on a 1024-byte boundary (the swizzle atom)
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + L::q_bytes;
  const uint32_t v_s = k_s + kStages * L::kv_bytes;
  const uint32_t q_full = hopper::smem_addr(&bars[0]);
  const uint32_t full0 = hopper::smem_addr(&bars[1]);
  const uint32_t empty0 = hopper::smem_addr(&bars[1 + kStages]);

  const int bh = blockIdx.x;  // b * hq + h: the coordinate of q and o
  const int h = bh % hq, b = bh / hq;
  const int kvz = b * hkv + h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;  // heaviest first
  const int nq = min(kTileQ, sq - q0);
  const int off = skv - sq;
  // the tile's live test, _flash_kernel's, on this tile's real rows: KV
  // tiles [t_lo, t_hi)
  const int q_first = q0 + off, q_last = q0 + nq - 1 + off;
  int t_hi = (skv + kTileK - 1) / kTileK;
  if (causal) t_hi = q_last < 0 ? 0 : min(t_hi, q_last / kTileK + 1);
  int t_lo = 0;
  if (window > 0 && q_first - window + 1 > 0) {
    t_lo = (q_first - window + 1) / kTileK;
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 4 * kConsumers);  // one per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    if constexpr (L::kMoveRegs) hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      hopper::mbar_expect_tx(q_full, L::q_bytes);
      for (int w = 0; w < kConsumers; ++w) {
        for (int c = 0; c < H; ++c) {
          hopper::tma_load_3d(q_s + (w * H + c) * kQBox, &qmap, q_full, 64 * c,
                              q0 + 64 * w, bh);
        }
      }
      for (int t = t_lo; t < t_hi; ++t) {
        const int it = t - t_lo, s = it % kStages;
        hopper::mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full0 + 8 * s, 2 * L::kv_bytes);
        for (int c = 0; c < H; ++c) {
          hopper::tma_load_3d(k_s + s * L::kv_bytes + c * kKBox, &kmap,
                              full0 + 8 * s, 64 * c, t * kTileK, kvz);
          hopper::tma_load_3d(v_s + s * L::kv_bytes + c * kKBox, &vmap,
                              full0 + 8 * s, 64 * c, t * kTileK, kvz);
        }
      }
    }
  } else {
    // consumers: 64 query rows each
    if constexpr (L::kMoveRegs) hopper::reg_alloc<L::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = q0 + 64 * wg + 16 * warp + lane / 4;  // rows row, row + 8
    const uint32_t qa = q_s + wg * H * kQBox;
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled s
    float l[2] = {0.f, 0.f};              // this thread's share of the sum

    hopper::mbar_wait(q_full, 0);
    for (int t = t_lo; t < t_hi; ++t) {
      const int it = t - t_lo, s = it % kStages;
      const uint32_t ks = k_s + s * L::kv_bytes, vs = v_s + s * L::kv_bytes;
      hopper::mbar_wait(full0 + 8 * s, (it / kStages) & 1);

      float sc[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // 16 columns of D: box kk / 4, 32 bytes into its rows per step
        const uint32_t step = (kk % 4) * 32;
        hopper::wgmma_ss<T>(
            sc, hopper::desc_sw128(qa + (kk / 4) * kQBox + step, 16, 1024),
            hopper::desc_sw128(ks + (kk / 4) * kKBox + step, 16, 1024),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);

      const int j0 = t * kTileK;
      if (j0 + kTileK > skv || (causal && j0 + kTileK - 1 > q_first) ||
          (window > 0 && j0 <= q_last - window)) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int qpos = row + 8 * hh + off;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = j0 + 8 * i + 2 * (lane % 4) + e;
              const bool ok = kpos < skv && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
              if (!ok) sc[4 * i + 2 * hh + e] = -INFINITY;
            }
          }
        }
      }

      float alpha[2], neg_m[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
        }
        const float m_new = fmaxf(m[hh], quad_max(mx) * scale_log2);
        // a row with no visible key yet keeps m = -inf: subtract 0, so p
        // and alpha come out 0 and not NaN
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[hh] = exp2_approx(m[hh] - m_use);
        neg_m[hh] = -m_use;
        m[hh] = m_new;
      }
      float lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int hh = j / 2;
          const float p =
              exp2_approx(__fmaf_rn(sc[4 * i + j], scale_log2, neg_m[hh]));
          sc[4 * i + j] = p;
          lsum[hh] += p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = __fmaf_rn(l[hh], alpha[hh], lsum[hh]);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * i + j] *= alpha[j / 2];
      }
      // P in the input type, as wgmma's register A: k-step kk covers the
      // S columns 16 kk .. 16 kk + 15, the 8-column blocks 2 kk and 2 kk + 1
      uint32_t pa[kTileK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 4 * (j / 2) + 2 * (j % 2);
          pa[kk][j] = pack2<T>(sc[i], sc[i + 1]);
        }
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        hopper::wgmma_rs_t<T>(acc, pa[kk],
                              hopper::desc_sw128(vs + kk * 16 * 128, kKBox,
                                                 1024),
                              1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: o = acc / max(l, 1e-30) in the input type, into this
    // warpgroup's Q boxes (swizzled as a load would leave them), then one
    // TMA store per box
    float denom[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) denom[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
    hopper::named_barrier(1 + wg, 128);  // the warpgroup's reads of Q are done
    uint8_t* const qp = base_ptr + wg * H * kQBox;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + lane / 4 + 8 * hh;
        const int c = (8 * i) % 64 + 2 * (lane % 4);
        const uint32_t byte = (8 * i / 64) * kQBox + r * 128 +
                              ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) * 2));
        *reinterpret_cast<uint32_t*>(qp + byte) =
            pack2<T>(acc[4 * i + 2 * hh] / denom[hh],
                     acc[4 * i + 2 * hh + 1] / denom[hh]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0 && q0 + 64 * wg < sq) {
      for (int c = 0; c < H; ++c) {
        hopper::tma_store_3d(&omap, qa + c * kQBox, 64 * c, q0 + 64 * wg, bh);
      }
      hopper::tma_store_commit_and_wait();
    }
  }
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int hq, int hkv, int sq, int skv, int d, int causal, int window,
              float scale, cudaStream_t stream) {
  using L = TcLayout<DH>;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap qm, km, vm, om;
  const uint64_t bq = static_cast<uint64_t>(b) * hq;
  const uint64_t bk = static_cast<uint64_t>(b) * hkv;
  cudaError_t err = hopper::map_3d(&qm, q, bf16, d, sq, bq, 64);
  if (err == cudaSuccess) err = hopper::map_3d(&om, o, bf16, d, sq, bq, 64);
  if (err == cudaSuccess) err = hopper::map_3d(&km, k, bf16, d, skv, bk, kTileK);
  if (err == cudaSuccess) err = hopper::map_3d(&vm, v, bf16, d, skv, bk, kTileK);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_kernel_tc<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bq),
                  (sq + L::kTileQ - 1) / L::kTileQ);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  flash_kernel_tc<T, DH><<<grid, L::kThreads, L::smem, stream>>>(
      qm, km, vm, om, hq, hkv, sq, skv, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dynamic shared memory, in bytes, of a launch at (dtype, d); 0 for a pair
// that flash_attention_launch refuses
REPRO_EXPORT int flash_attention_smem_bytes(int dtype, int d) {
  if (dtype == 0) {
    switch (d) {
      case 16: return static_cast<int>(smem_bytes<16>());
      case 32: return static_cast<int>(smem_bytes<32>());
      case 64: return static_cast<int>(smem_bytes<64>());
      case 96: return static_cast<int>(smem_bytes<96>());
      case 112: return static_cast<int>(smem_bytes<112>());
      case 128: return static_cast<int>(smem_bytes<128>());
      default: return 0;
    }
  }
  if ((dtype != 1 && dtype != 2) || d < 8 || d > 128 || d % 8 != 0) return 0;
  return static_cast<int>(d <= 64 ? TcLayout<64>::smem : TcLayout<128>::smem);
}

// q (b, hq, sq, d), k / v (b, hkv, skv, d), o (b, hq, sq, d), contiguous
// and 16-byte aligned; dtype 0 float32 (d in {16, 32, 64, 96, 112, 128}),
// 1 bfloat16 or 2 float16 (d a multiple of 8, at most 128); hq a multiple
// of hkv; window <= 0 for none.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int b, int hq, int hkv, int sq,
                                        int skv, int d, int causal, int window,
                                        float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
      case 32: return launch_f32<32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
      case 64: return launch_f32<64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
      case 96: return launch_f32<96>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
      case 112: return launch_f32<112>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
      case 128: return launch_f32<128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if ((dtype != 1 && dtype != 2) || d < 8 || d > 128 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    return d <= 64 ? launch_tc<__nv_bfloat16, 64>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s)
                   : launch_tc<__nv_bfloat16, 128>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
  }
  return d <= 64 ? launch_tc<__half, 64>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s)
                 : launch_tc<__half, 128>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
}
