// Exact brute-force k nearest neighbours: for each query the k smallest
// euclidean distances over all N points, ascending, ties to the lower
// point index, as sqrt distances and int32 indices.
//
// Replaces: src/repro/kernels/bruteforce_knn.py::bruteforce_knn_pallas
//   (bodies _knn_kernel and _select_k). The TPU kernel formed a (bq, bn)
//   panel of d2 = |q|^2 - 2 q.p + |p|^2 on the MXU for each step of its
//   sequential point axis and merged it into a (bq, k) running best by k
//   rounds of extract-min.
// Bound on this card: operations. Q * N pairs of 2 * dim + 4 operations
//   (the dot product, the expansion, the clamp and the compare with the
//   k-th best), against (Q + N) * dim * 4 + Q * k * 8 bytes: at Q = 2^13,
//   N = 2^20, dim 3, 1.28 ms at 67 T/s against 12.6 MB (3.8 us).
// Design: the point axis is cut into S chunks, one per block row of a
//   (query tiles) x (S) grid, so that the grid fills the card at any Q
//   (one thread per query and one block per query tile left 2 warps per
//   SM at Q = 2^13; kernels.bruteforce_knn.plan picks S). A block of 128
//   threads holds 256 queries in registers (128 with the 256-slot heap:
//   kQueriesPerThread) and streams its chunk through shared memory, a
//   stage at a time, in ascending index order; in 3-D each point is one
//   16-byte (x, y, z, |p|^2) entry, one broadcast vector load per point
//   for the whole warp. Each block writes every query's list of its
//   chunk, (d2, index) ascending, to scratch laid out (S, k, Q); a second
//   kernel (merge_kernel, one thread per query) takes the S lists in
//   chunk order and keeps the k smallest by (d2, index). The chunks are
//   disjoint and each list holds its chunk's k smallest by that key, so
//   the merge gives the twin's list bit for bit. When one chunk covers
//   every point (S = 1) the scan writes the result itself. In 3-D a
//   thread takes four points at a time and puts each one below its
//   query's k-th best into the query's queue in shared memory (16
//   entries); the queues enter the lists when a warp vote finds one that
//   could overflow, and at the end of a chunk. An insert taken in the
//   scan loop stalls the whole warp for any one lane's candidate (32
//   times the inserts early in a chunk, where most points enter);
//   queued, each lane inserts only its own.
//   The float order is the one XLA:CPU gives the reference's kernel up
//   to dim 10: |q|^2 and |p|^2 with every square rounded, summed from
//   dimension 0; q.p as q0*p0, then one fused multiply-add per further
//   dimension; d2 = max((|q|^2 - 2 q.p) + |p|^2, 0). The library is built
//   with --fmad=false, so nothing else is contracted. Within a chunk a
//   point enters the list when d2 < the k-th best (strict), after any
//   equal entries, which in ascending index order is the key (d2, index);
//   the merge compares whole keys (knn_list.cuh, ascending positions).
//   Each list is a heap in local memory (16, 32 or 256 slots): with the
//   sorted register lists ptxas gave the scan some 255 registers, two
//   blocks an SM, and bounding them spilled the hot loop; the heap leaves
//   the loop a register for tau.
//   The reference's k > N quirk: past the last finite candidate its rows
//   repeat (inf, the index in column 0 of its running best carried into
//   the last panel), which is -1 for one panel and, for more, the nearest
//   point below the last panel's start (`tail_from`). One chunk boundary
//   lies at tail_from, so the merge takes that index as the smallest key
//   of the chunks below it, read as it reaches the first chunk above
//   (the one-chunk scan reads it as it reaches tail_from), and writes it
//   into every row that holds no point.
#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "knn_list.cuh"

namespace {

constexpr int kThreads = 128;    // threads of a scan or merge block
constexpr int kMaxRegDim = 16;   // widest query held in registers
constexpr int kTile3 = 512;      // 3-D points per shared-memory stage
constexpr int kQueue = 16;       // 3-D: candidates a query's queue holds
constexpr int kMaxTileFloats = 8192;
constexpr int kLargeK = 256;     // the heap's slots
constexpr int kMaxSplits = 65535;

// queries a thread of the scan holds, each staged point serving all of
// them: two with the 16- and 32-slot heaps, one with the 256-slot heap
// (scripts/knn_variants.py times both)
template <class List>
constexpr int kQueriesPerThread = List::kSlots <= 32 ? 2 : 1;

// the chunk of block row s: [0, n) for the one-chunk scan; else `chunk`
// points at a time from 0 up to tail_from (rows s < s_lo), then from
// tail_from up to n
__device__ __forceinline__ void chunk_of(int s, int n, int tail_from,
                                         int chunk, int s_lo, int whole,
                                         int& c0, int& c1) {
  if (whole) {
    c0 = 0;
    c1 = n;
  } else if (s < s_lo) {
    c0 = s * chunk;
    c1 = min(c0 + chunk, tail_from);
  } else {
    c0 = tail_from + (s - s_lo) * chunk;
    c1 = min(c0 + chunk, n);
  }
}

// 3-D: d2 of the query (qc, q2) to the staged point p, in the kernel's
// float order
__device__ __forceinline__ float d2_of(const float (&qc)[3], float q2,
                                       float4 p) {
  float qp = __fmul_rn(qc[0], p.x);
  qp = __fmaf_rn(qc[1], p.y, qp);
  qp = __fmaf_rn(qc[2], p.z, qp);
  return max_nan(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, qp)), p.w), 0.0f);
}

// the result of one query: sqrt distances, and `tail` where no point is
template <class List>
__device__ __forceinline__ void write_result(List& best, int k, int tail,
                                             float* od, int* oi) {
  best.finish(k);
  if constexpr (List::kInRegisters) {
#pragma unroll
    for (int j = 0; j < List::kSlots; ++j) {
      if (j < k) {
        od[j] = sqrtf(best.dist(j));
        oi[j] = best.pos(j) < 0 ? tail : best.pos(j);
      }
    }
  } else {
    for (int j = 0; j < k; ++j) {
      od[j] = sqrtf(best.dist(j));
      oi[j] = best.pos(j) < 0 ? tail : best.pos(j);
    }
  }
}

// the queued candidates of query u of this thread, in ascending index,
// into its list: each still strictly below tau enters
template <class List>
__device__ __forceinline__ void drain(List& best, const float* q_d,
                                      const int* q_i, int u, int queued,
                                      int k) {
#pragma unroll 1
  for (int e = 0; e < queued; ++e) {
    const int at = (u * kQueue + e) * kThreads + threadIdx.x;
    const float d2 = q_d[at];
    if (best.admits_strict(d2)) best.insert_later(d2, q_i[at], k);
  }
}

// DIM == 3: three dimensions, points staged as (x, y, z, |p|^2); DIM ==
// -1: dim <= kMaxRegDim, the query in registers; DIM == 0: any dim, the
// query read through the read-only cache. whole: one chunk of every
// point, the result written here (dists / idxs); else the chunk's list
// to the (S, k, q) scratch (part_d / part_i).
template <int DIM, class List>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ queries,
                const float* __restrict__ points, int q, int n, int dim,
                int k, int tile, int tail_from, int chunk, int s_lo,
                int whole, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  constexpr int kQpt = kQueriesPerThread<List>;
  // 3-D: (x, y, z, |p|^2) per point, then the candidate queues, (d2,
  // index) in slot-major order; else p (tile, dim), then |p|^2
  extern __shared__ __align__(16) float smem[];
  float4* s_p4 = reinterpret_cast<float4*>(smem);
  float* s_p = smem;
  float* s_p2 = smem + tile * dim;
  float* q_d = smem + 4 * tile;
  int* q_i = reinterpret_cast<int*>(q_d + kQpt * kQueue * kThreads);
  constexpr int R = DIM > 0 ? DIM : (DIM == -1 ? kMaxRegDim : 1);
  int c0, c1;
  chunk_of(blockIdx.y, n, tail_from, chunk, s_lo, whole, c0, c1);

  int qi[kQpt];
  const float* qrow[kQpt];
  float qc[kQpt][R];
  float q2[kQpt];
  List best[kQpt];
  int tail[kQpt];
  bool any_live = false;
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    qi[u] = blockIdx.x * (kThreads * kQpt) + u * kThreads + threadIdx.x;
    any_live = any_live || qi[u] < q;
    qrow[u] = queries + static_cast<long long>(qi[u] < q ? qi[u] : 0) * dim;
    if constexpr (DIM != 0) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if (DIM > 0 || c < dim) {
          qc[u][c] = qrow[u][c];
          const float s = __fmul_rn(qc[u][c], qc[u][c]);
          q2[u] = c == 0 ? s : __fadd_rn(q2[u], s);
        }
      }
    } else {
      q2[u] = __fmul_rn(qrow[u][0], qrow[u][0]);
      for (int c = 1; c < dim; ++c) {
        q2[u] = __fadd_rn(q2[u], __fmul_rn(qrow[u][c], qrow[u][c]));
      }
    }
    best[u].init(k);
    tail[u] = -1;
  }

  for (int base = c0; base < c1; base += tile) {
    const int nt = min(tile, c1 - base);
    __syncthreads();
    if constexpr (DIM == 3) {
      for (int j = threadIdx.x; j < nt; j += blockDim.x) {
        const float* p = points + static_cast<long long>(base + j) * 3;
        const float x = p[0], y = p[1], z = p[2];
        const float p2 =
            __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                      __fmul_rn(z, z));
        s_p4[j] = make_float4(x, y, z, p2);
      }
    } else {
      const long long off = static_cast<long long>(base) * dim;
      for (int e = threadIdx.x; e < nt * dim; e += blockDim.x) {
        s_p[e] = points[off + e];
      }
      __syncthreads();
      for (int j = threadIdx.x; j < nt; j += blockDim.x) {
        const float* p = s_p + j * dim;
        float p2 = __fmul_rn(p[0], p[0]);
        for (int c = 1; c < dim; ++c) {
          p2 = __fadd_rn(p2, __fmul_rn(p[c], p[c]));
        }
        s_p2[j] = p2;
      }
    }
    __syncthreads();
    if (DIM != 3 && !any_live) continue;   // 3-D: the warp votes below
    // the one-chunk scan reads the tail as it reaches tail_from: the
    // stage's points [0, at), the snapshot, then [at, nt)
    const int at = whole && tail_from >= base && tail_from - base < nt
                       ? tail_from - base : nt;
#pragma unroll 1
    for (int seg = 0; seg < 2; ++seg) {
      const int j0 = seg == 0 ? 0 : at;
      const int j1 = seg == 0 ? at : nt;
      if (seg == 1 && at < nt) {
#pragma unroll
        for (int u = 0; u < kQpt; ++u) tail[u] = best[u].first_pos();
      }
      if constexpr (DIM == 3) {
        // four points at a time; a point below tau joins the query's
        // queue in shared memory, in ascending index, and the queues
        // enter the lists when one in the warp could overflow (a warp
        // vote) and at the end of the segment: an insert runs once per
        // candidate, not once per candidate of any lane of the warp
        int queued[kQpt];
#pragma unroll
        for (int u = 0; u < kQpt; ++u) queued[u] = 0;
#pragma unroll 1
        for (int j = j0; j < j1; j += 4) {
          float4 p[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) p[v] = s_p4[min(j + v, j1 - 1)];
          bool full = false;
#pragma unroll
          for (int u = 0; u < kQpt; ++u) {
            float d[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) d[v] = d2_of(qc[u], q2[u], p[v]);
            if (j + 4 > j1) {   // the segment's last, partial group
#pragma unroll
              for (int v = 1; v < 4; ++v) d[v] = j + v < j1 ? d[v] : INFINITY;
            }
            const float tau = best[u].bound();
            // fminf drops NaN, which is never admitted
            if (fminf(fminf(d[0], d[1]), fminf(d[2], d[3])) < tau) {
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                if (d[v] < tau) {
                  const int slot = (u * kQueue + queued[u]) * kThreads +
                                   threadIdx.x;
                  q_d[slot] = d[v];
                  q_i[slot] = base + j + v;
                  ++queued[u];
                }
              }
            }
            full = full || queued[u] > kQueue - 4;
          }
          if (__any_sync(0xffffffffu, full)) {
#pragma unroll
            for (int u = 0; u < kQpt; ++u) {
              drain(best[u], q_d, q_i, u, queued[u], k);
              queued[u] = 0;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kQpt; ++u) drain(best[u], q_d, q_i, u, queued[u], k);
      } else {
#pragma unroll 1
        for (int j = j0; j < j1; ++j) {
          const float* p = s_p + j * dim;
#pragma unroll
          for (int u = 0; u < kQpt; ++u) {
            float qp;
            if constexpr (DIM != 0) {
              qp = __fmul_rn(qc[u][0], p[0]);
#pragma unroll
              for (int c = 1; c < R; ++c) {
                if (DIM > 0 || c < dim) qp = __fmaf_rn(qc[u][c], p[c], qp);
              }
            } else {
              qp = __fmul_rn(__ldg(qrow[u]), p[0]);
              for (int c = 1; c < dim; ++c) {
                qp = __fmaf_rn(__ldg(qrow[u] + c), p[c], qp);
              }
            }
            const float d2 = max_nan(
                __fadd_rn(__fsub_rn(q2[u], __fmul_rn(2.0f, qp)), s_p2[j]),
                0.0f);
            if (best[u].admits_strict(d2)) {
              best[u].insert_later(d2, base + j, k);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    if (qi[u] >= q) continue;
    if (whole) {
      write_result(best[u], k, tail[u],
                   out_d + static_cast<long long>(qi[u]) * k,
                   out_i + static_cast<long long>(qi[u]) * k);
      continue;
    }
    best[u].finish(k);
    const long long o = static_cast<long long>(blockIdx.y) * k * q + qi[u];
    if constexpr (List::kInRegisters) {
#pragma unroll
      for (int j = 0; j < List::kSlots; ++j) {
        if (j < k) {
          out_d[o + static_cast<long long>(j) * q] = best[u].dist(j);
          out_i[o + static_cast<long long>(j) * q] = best[u].pos(j);
        }
      }
    } else {
      for (int j = 0; j < k; ++j) {
        out_d[o + static_cast<long long>(j) * q] = best[u].dist(j);
        out_i[o + static_cast<long long>(j) * q] = best[u].pos(j);
      }
    }
  }
}

// one thread per query: the S lists in chunk order, each ascending, into
// the k smallest by (d2, index); the tail is the smallest key of the rows
// below s_lo (the chunks below tail_from), -1 when there are none
template <class List>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, int q, int k, int splits,
                 int s_lo, float* __restrict__ dists,
                 int* __restrict__ idxs) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  List best;
  best.init(k);
  int tail = -1;
  for (int s = 0; s < splits; ++s) {
    if (s == s_lo) tail = best.first_pos();
    const long long o = static_cast<long long>(s) * k * q + qi;
    for (int j = 0; j < k; ++j) {
      const float d2 = __ldg(part_d + o + static_cast<long long>(j) * q);
      const int idx = __ldg(part_i + o + static_cast<long long>(j) * q);
      if (!best.admits(d2, idx)) break;   // the rest of the list is above
      best.insert(d2, idx, k);
    }
  }
  write_result(best, k, tail, dists + static_cast<long long>(qi) * k,
               idxs + static_cast<long long>(qi) * k);
}

struct Launch {
  const float* queries;
  const float* points;
  int q, n, dim, k, tile, tail_from, chunk, s_lo, splits;
  float* dists;
  int* idxs;
  float* part_d;
  int* part_i;
  cudaStream_t stream;
};

template <int DIM, class List>
cudaError_t launch(const Launch& a) {
  constexpr int kQpt = kQueriesPerThread<List>;
  const size_t shmem =
      DIM == 3 ? sizeof(float4) * a.tile +
                     (sizeof(float) + sizeof(int)) * kQpt * kQueue * kThreads
               : sizeof(float) * (static_cast<size_t>(a.tile) * a.dim + a.tile);
  const dim3 grid((a.q + kThreads * kQpt - 1) / (kThreads * kQpt), a.splits);
  const bool whole = a.splits == 1;
  scan_kernel<DIM, List><<<grid, kThreads, shmem, a.stream>>>(
      a.queries, a.points, a.q, a.n, a.dim, a.k, a.tile, a.tail_from, a.chunk,
      a.s_lo, whole, whole ? a.dists : a.part_d, whole ? a.idxs : a.part_i);
  const cudaError_t err = cudaGetLastError();
  if (whole || err != cudaSuccess) return err;
  merge_kernel<List><<<(a.q + kThreads - 1) / kThreads, kThreads, 0,
                       a.stream>>>(a.part_d, a.part_i, a.q, a.k, a.splits,
                                   a.s_lo, a.dists, a.idxs);
  return cudaGetLastError();
}

template <int DIM>
cudaError_t launch_k(const Launch& a) {
  using knn::KeyHeap;
  if (a.k <= 16) return launch<DIM, KeyHeap<16, false>>(a);
  if (a.k <= 32) return launch<DIM, KeyHeap<32, false>>(a);
  return launch<DIM, KeyHeap<kLargeK, false>>(a);
}

}  // namespace

// queries (q, dim), points (n, dim), float32 and contiguous; dists (q, k)
// float32, idxs (q, k) int32. tail_from: the start of the reference's last
// panel of points (0 for one panel). chunk: points per block row; chunk
// >= n scans every point in one block row, else part_d / part_i hold
// splits * k * q floats / ints of scratch, splits = ceil(tail_from /
// chunk) + ceil((n - tail_from) / chunk) (kernels.bruteforce_knn.splits).
REPRO_EXPORT int bruteforce_knn_launch(const void* queries, const void* points,
                                       int q, int n, int dim, int k,
                                       int tail_from, int chunk, void* dists,
                                       void* idxs, void* part_d, void* part_i,
                                       void* stream) {
  if (q < 1 || n < 1 || dim < 1 || dim > kMaxTileFloats || k < 1 ||
      k > kLargeK || tail_from < 0 || tail_from >= n || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{static_cast<const float*>(queries), static_cast<const float*>(points),
           q, n, dim, k, 0, tail_from, chunk, 0, 1,
           static_cast<float*>(dists), static_cast<int*>(idxs),
           static_cast<float*>(part_d), static_cast<int*>(part_i),
           static_cast<cudaStream_t>(stream)};
  a.tile = dim == 3 ? kTile3 : std::max(1, std::min(256, kMaxTileFloats / dim));
  if (chunk < n) {
    a.s_lo = (tail_from + chunk - 1) / chunk;
    const long long splits =
        a.s_lo + (static_cast<long long>(n) - tail_from + chunk - 1) / chunk;
    if (splits > kMaxSplits || part_d == nullptr || part_i == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.splits = static_cast<int>(splits);
  }
  if (dim == 3) return static_cast<int>(launch_k<3>(a));
  if (dim <= kMaxRegDim) return static_cast<int>(launch_k<-1>(a));
  return static_cast<int>(launch_k<0>(a));
}
