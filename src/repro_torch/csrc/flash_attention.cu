// Flash attention: causal, sliding-window, GQA online-softmax attention.
// q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D), contiguous, all of one type
// (float32, bfloat16 or float16); o (B, Hq, Sq, D) in that type. Query
// head h reads KV head h / (Hq / Hkv). Query row i sits at position
// i + (Skv - Sq) (right-aligned); key j is visible when j < Skv, j <= the
// row's position (causal) and j > position - window (window > 0).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (body _flash_kernel). The TPU kernel carried each (batch, head,
//   q-block) row state (m, l, acc) in VMEM scratch across the sequential
//   KV axis of its grid and skipped KV blocks that were wholly masked.
//   Here one block owns one (batch, query head, 64-row query tile), keeps
//   the row states in registers, and a loop over 64-key KV tiles takes the
//   place of the grid's KV axis, with the same live test per tile.
// Arithmetic, as _flash_kernel's, in float32: s = (q * scale) . k with
//   scale = 1/sqrt(D) applied to q first; masked entries -1e30;
//   m' = max(m, max_j s), alpha = exp(m - m'), p = exp(s - m') masked to
//   0 after the exp, l' = l alpha + sum_j p, acc' = acc alpha + p . v;
//   o = acc / max(l, 1e-30), so a row with no visible key gives 0.
//   Products are placed with fmaf (the build turns contraction off) and
//   exp is expf; the sums run in another order than XLA's, so the result
//   agrees with the twin to float32 rounding, not bit for bit.
// Bound on this card: operations. 4 D per visible (query, key) pair
//   (two products of length D), against q, k, v read once and o written
//   once; at B = 4, Hq = 32, Hkv = 4, S = 2048, D = 64 in bfloat16 causal:
//   68.7 GFLOP / 989 TFLOP/s (bf16 tensor cores) = 0.0695 ms, bytes
//   75.5 MB / 3.35 TB/s = 0.0225 ms.
// Design, and what it leaves on the table: 4 warps, 16 query rows each.
//   The tile's q (scaled), K and V are staged in shared memory as float32.
//   For 4 rows at a time each lane scores 2 keys (float4 reads of a
//   padded K row, q broadcast), a warp shuffle takes the row max and sum,
//   the probabilities go through warp-private shared memory and each lane
//   accumulates D/32 output columns. Everything runs on the CUDA cores in
//   float32, at most 67 TFLOP/s: the tensor cores (wgmma on bf16 tiles,
//   p rounded to bf16), TMA staging with a pipeline of K/V tiles, larger
//   query tiles and the write of o through shared memory are the redesign.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;  // rows per warp
constexpr int kGroup = 4;            // rows scored together
constexpr float kNegInf = -1e30f;

// 4 consecutive elements of T as float32, and one stored back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, int causal, int window, float scale) {
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
        if (D % 32 == 0 || d < D) store(o + (qrow0 + r) * D + d, acc[i][t] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int sq, int skv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t shmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T, D><<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, hq, sq, d), k / v (b, hkv, skv, d), o (b, hq, sq, d), contiguous
// and 16-byte aligned; dtype 0 float32, 1 bfloat16, 2 float16; d in
// {16, 32, 64, 96, 128}; hq a multiple of hkv; window <= 0 for none.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int b, int hq, int hkv, int sq,
                                        int skv, int d, int causal, int window,
                                        float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
    case 2: return launch_d<__half>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
