// Exact brute-force k nearest neighbours: for each query the k smallest
// euclidean distances over all N points, ascending, ties to the lower
// point index, as sqrt distances and int32 indices.
//
// Replaces: src/repro/kernels/bruteforce_knn.py::bruteforce_knn_pallas
//   (bodies _knn_kernel and _select_k). The TPU kernel formed a (bq, bn)
//   panel of d2 = |q|^2 - 2 q.p + |p|^2 on the MXU for each step of its
//   sequential point axis and merged it into a (bq, k) running best by k
//   rounds of extract-min. Here one thread holds one query and its sorted
//   running best, and each block streams every point through shared
//   memory, a tile at a time, in ascending index order.
// Bound on this card: operations. Q * N pairs of 2 * dim + 4 operations
//   (the dot product, the expansion, the clamp and the compare with the
//   k-th best), against (Q + N) * dim * 4 + Q * k * 8 bytes: at Q = 2^13,
//   N = 2^20, dim 3, 1.28 ms at 67 T/s against 12.6 MB (3.8 us).
// Design: queries in registers (dim <= 16; wider rows are read through
//   the read-only cache), each tile's |p|^2 computed once per tile by the
//   block. The float order is the one XLA:CPU gives the reference's
//   kernel up to dim 10: |q|^2 and |p|^2 with every square rounded, summed
//   from dimension 0; q.p as q0*p0, then one fused multiply-add per
//   further dimension; d2 = max((|q|^2 - 2 q.p) + |p|^2, 0). The library
//   is built with --fmad=false, so nothing else is contracted. A point
//   enters the list when d2 < the k-th best (strict), after any equal
//   entries: with points in ascending index order that is the
//   reference's "smallest (d2, index)". Lists of up to 32 live in
//   registers; longer ones (up to 256) in local memory.
//   The reference's k > N quirk: past the last finite candidate its rows
//   repeat (inf, the index in column 0 of its running best carried into
//   the last panel), which is -1 for one panel and, for more, the nearest
//   point below the last panel's start (`tail_from`). The kernel snapshots
//   list[0]'s index as the scan reaches `tail_from` and writes it into
//   every row that holds no point.
// Occupancy is the first thing a redesign addresses: at Q = 2^13 one
//   thread per query makes 128 blocks of 64 threads, 2 warps per SM of
//   the 64 an SM can hold. Splitting N across blocks (with a merge that
//   takes the chunks in index order) or a tensor-core dot panel are later
//   work.
#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;     // queries per block
constexpr int kMaxRegDim = 16;   // widest query held in registers
constexpr int kMaxTileFloats = 8192;
constexpr int kLargeK = 256;     // the local-memory list

template <int K, bool kRegs>
struct Best {
  float d[K];
  int i[K];
  float tau;  // the k-th best: the strict prune bound

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = INFINITY;
      i[j] = -1;
    }
    tau = INFINITY;
  }

  // d2 < tau: insert after equal entries, drop the k-th
  __device__ __forceinline__ void insert(float d2, int idx, int k) {
    if constexpr (kRegs) {
      // entries past k stay >= the k-th > d2, so counting over all K
      // slots gives the same position
      int pos = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) pos += d[j] <= d2 ? 1 : 0;
#pragma unroll
      for (int j = K - 1; j > 0; --j) {
        if (j > pos) {
          d[j] = d[j - 1];
          i[j] = i[j - 1];
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j == pos) {
          d[j] = d2;
          i[j] = idx;
        }
        if (j == k - 1) tau = d[j];
      }
    } else {
      int j = k - 1;
      while (j > 0 && d[j - 1] > d2) {
        d[j] = d[j - 1];
        i[j] = i[j - 1];
        --j;
      }
      d[j] = d2;
      i[j] = idx;
      tau = d[k - 1];
    }
  }
};

// DIM > 0: exactly DIM dimensions; DIM == -1: dim <= kMaxRegDim, in
// registers; DIM == 0: any dim, the query read through the read-only cache
template <int DIM, int K, bool kRegs>
__global__ void bruteforce_knn_kernel(const float* __restrict__ queries,
                                      const float* __restrict__ points, int q,
                                      int n, int dim, int k, int tile,
                                      int tail_from, float* __restrict__ dists,
                                      int* __restrict__ idxs) {
  extern __shared__ float smem[];  // p (tile, dim), then |p|^2 (tile,)
  float* s_p = smem;
  float* s_p2 = smem + tile * dim;
  constexpr int R = DIM > 0 ? DIM : (DIM == -1 ? kMaxRegDim : 1);
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < q;
  const float* qrow = queries + static_cast<long long>(live ? qi : 0) * dim;

  float qc[R];
  float q2 = 0.0f;
  if constexpr (DIM != 0) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      if (DIM > 0 || c < dim) {
        qc[c] = qrow[c];
        const float s = __fmul_rn(qc[c], qc[c]);
        q2 = c == 0 ? s : __fadd_rn(q2, s);
      }
    }
  } else {
    q2 = __fmul_rn(qrow[0], qrow[0]);
    for (int c = 1; c < dim; ++c) {
      q2 = __fadd_rn(q2, __fmul_rn(qrow[c], qrow[c]));
    }
  }

  Best<K, kRegs> best;
  best.init();
  int tail = -1;

  for (int base = 0; base < n; base += tile) {
    const int nt = min(tile, n - base);
    __syncthreads();
    const long long off = static_cast<long long>(base) * dim;
    for (int e = threadIdx.x; e < nt * dim; e += blockDim.x) {
      s_p[e] = points[off + e];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += blockDim.x) {
      const float* p = s_p + j * dim;
      float p2 = __fmul_rn(p[0], p[0]);
      for (int c = 1; c < dim; ++c) p2 = __fadd_rn(p2, __fmul_rn(p[c], p[c]));
      s_p2[j] = p2;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nt; ++j) {
      if (base + j == tail_from) tail = best.i[0];
      const float* p = s_p + j * dim;
      float qp;
      if constexpr (DIM != 0) {
        qp = __fmul_rn(qc[0], p[0]);
#pragma unroll
        for (int c = 1; c < R; ++c) {
          if (DIM > 0 || c < dim) qp = __fmaf_rn(qc[c], p[c], qp);
        }
      } else {
        qp = __fmul_rn(__ldg(qrow), p[0]);
        for (int c = 1; c < dim; ++c) qp = __fmaf_rn(__ldg(qrow + c), p[c], qp);
      }
      const float d2 = max_nan(
          __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, qp)), s_p2[j]), 0.0f);
      if (d2 < best.tau) best.insert(d2, base + j, k);
    }
  }
  if (!live) return;
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  if constexpr (kRegs) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        od[j] = sqrtf(best.d[j]);
        oi[j] = best.i[j] < 0 ? tail : best.i[j];
      }
    }
  } else {
    for (int j = 0; j < k; ++j) {
      od[j] = sqrtf(best.d[j]);
      oi[j] = best.i[j] < 0 ? tail : best.i[j];
    }
  }
}

template <int DIM, int K, bool kRegs>
cudaError_t launch(const float* queries, const float* points, int q, int n,
                   int dim, int k, int tile, int tail_from, float* dists,
                   int* idxs, cudaStream_t stream) {
  const int blocks = (q + kThreads - 1) / kThreads;
  const size_t shmem = sizeof(float) * (static_cast<size_t>(tile) * dim + tile);
  bruteforce_knn_kernel<DIM, K, kRegs><<<blocks, kThreads, shmem, stream>>>(
      queries, points, q, n, dim, k, tile, tail_from, dists, idxs);
  return cudaGetLastError();
}

template <int DIM>
cudaError_t launch_k(const float* queries, const float* points, int q, int n,
                     int dim, int k, int tile, int tail_from, float* dists,
                     int* idxs, cudaStream_t s) {
  if (k <= 8) {
    return launch<DIM, 8, true>(queries, points, q, n, dim, k, tile,
                                tail_from, dists, idxs, s);
  }
  if (k <= 16) {
    return launch<DIM, 16, true>(queries, points, q, n, dim, k, tile,
                                 tail_from, dists, idxs, s);
  }
  if (k <= 32) {
    return launch<DIM, 32, true>(queries, points, q, n, dim, k, tile,
                                 tail_from, dists, idxs, s);
  }
  return launch<DIM, kLargeK, false>(queries, points, q, n, dim, k, tile,
                                     tail_from, dists, idxs, s);
}

}  // namespace

// queries (q, dim), points (n, dim), float32 and contiguous; dists (q, k)
// float32, idxs (q, k) int32. tail_from: the start of the reference's last
// panel of points (0 for one panel).
REPRO_EXPORT int bruteforce_knn_launch(const void* queries, const void* points,
                                       int q, int n, int dim, int k,
                                       int tail_from, void* dists, void* idxs,
                                       void* stream) {
  if (q < 1 || n < 1 || dim < 1 || dim > kMaxTileFloats || k < 1 ||
      k > kLargeK || tail_from < 0 || tail_from >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = std::max(1, std::min(256, kMaxTileFloats / dim));
  auto qp = static_cast<const float*>(queries);
  auto pp = static_cast<const float*>(points);
  auto d = static_cast<float*>(dists);
  auto ix = static_cast<int*>(idxs);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dim == 2) {
    err = launch_k<2>(qp, pp, q, n, dim, k, tile, tail_from, d, ix, s);
  } else if (dim == 3) {
    err = launch_k<3>(qp, pp, q, n, dim, k, tile, tail_from, d, ix, s);
  } else if (dim <= kMaxRegDim) {
    err = launch_k<-1>(qp, pp, q, n, dim, k, tile, tail_from, d, ix, s);
  } else {
    err = launch_k<0>(qp, pp, q, n, dim, k, tile, tail_from, d, ix, s);
  }
  return static_cast<int>(err);
}
