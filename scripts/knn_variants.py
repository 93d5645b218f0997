#!/usr/bin/env python3
"""Time design variants of the kNN walk (``bvh_traverse_knn``) and of
brute-force kNN (``bruteforce_knn``) on one CUDA card, in turns.

    python3 scripts/knn_variants.py [walk | bf]   # from the checkout root;
                                                  # one phase, or both

Each variant is either a text edit of the committed
``src/repro_torch/csrc/bvh_traverse.cu`` or ``bruteforce_knn.cu``, built
with the port's nvcc flags into ``build/knn_variants/``, or the committed
library called through its C entry point with other arguments:

  kNN walk (``chip_smoke.py``'s 2^20 search points, Q = 2^17 uniform
  queries in the caller's order, k = 10; then the points themselves)
    committed        nearest first, node records, the caller's order
    morton_order     a Morton order of the queries computed per call (its
                     step timed apart)
    no_records       the any-dim instance over the flat arrays
    parent_rope_walk the parent's stackless rope walk (its kernel appended
                     to the source, with its own C entry)
  the self-kNN case (Q = N = 2^20): the leaf order against the caller's
  order, and the rope walk; the k = 1, 32 and 256 buckets against the
  rope walk (k = 256 on 2^13 of the queries, then the committed walk on
  all); node tests per query, and the queries that take the tie
  pass, from an edited build that counts them (``counted``).
  brute force (``chip_smoke.py``'s Q = 2^13 of the queries against the
  2^20 points, k = 10; then k = 256 at Q = 1024, N = 2^16)
    committed        the planned chunk (kernels.bruteforce_knn.plan)
    quarter_splits, half_splits
                     chunks four and two times as long (about S/4, S/2
                     block rows)
    double_splits    chunks half as long (about 2 S)
    register_lists   the sorted register lists of the walk (KeyList 8,
                     16, 32) for k <= 32 instead of the heaps, one query
                     a thread (an edit)
    no_queue         3-D: every candidate enters the list at once, without
                     the shared-memory queue (an edit)
    ptx_max          3-D: max(x, 0) by PTX max.NaN, one instruction, not
                     common.cuh's max_nan (an edit; x is never -0)
    one_query        one query a thread where the kernel holds two (an
                     edit), the planned chunk (twice the blocks)
    parent_design    one chunk of every point and 64-thread blocks (an
                     edit): one block per query tile, as before

Each variant is first held bit-identical to the committed kernel, then
timed by CUDA events; the variants run in one order and then in the
reverse one, and each line gives both times. Needs one card; exits
nonzero without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUT = os.path.join(ROOT, "build", "knn_variants")
BUCKETS = (1, 32, 256)
#: queries of the k = 256 comparison with the rope walk
PARENT_Q_256 = 1 << 13

# the parent's kNN kernel: the stackless rope walk from the root, left
# first, tau at +inf, a sorted register list that inserts before equal
# entries (its twin's order), one thread per query
ROPE_WALK = r"""
namespace {

template <int K>
__global__ void rope_knn_kernel(Tree t, const float* __restrict__ queries,
                                int q, int k, float* __restrict__ dists,
                                int* __restrict__ idxs) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int dim = t.dim;
  float qc[kMaxDim];
#pragma unroll
  for (int c = 0; c < kMaxDim; ++c) {
    if (c < dim) qc[c] = queries[static_cast<long long>(qi) * dim + c];
  }
  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = __int_as_float(0x7f800000);
    best_i[j] = -1;
  }
  float tau2 = best_d[0];
  int node = 0;
  while (node != -1) {
    const float* lo = t.lo + static_cast<long long>(node) * dim;
    const float* hi = t.hi + static_cast<long long>(node) * dim;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxDim; ++c) {
      if (c < dim) {
        const float g = max_nan(max_nan(__ldg(lo + c) - qc[c],
                                        qc[c] - __ldg(hi + c)), 0.0f);
        d2 = c == 0 ? g * g : __fmaf_rn(g, g, d2);
      }
    }
    const bool promising = d2 < tau2;
    const bool is_leaf = node >= t.n - 1;
    if (is_leaf) {
      if (promising) {
        const int orig = __ldg(t.perm + (node - (t.n - 1)));
        int pos = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) pos += best_d[j] < d2 ? 1 : 0;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (j > pos) {
            best_d[j] = best_d[j - 1];
            best_i[j] = best_i[j - 1];
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (j == pos) {
            best_d[j] = d2;
            best_i[j] = orig;
          }
          if (j == k - 1) tau2 = best_d[j];
        }
      }
      node = __ldg(t.rope + node);
    } else {
      node = promising ? __ldg(t.left + node) : __ldg(t.rope + node);
    }
  }
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      od[j] = sqrtf(best_d[j]);
      oi[j] = best_i[j];
    }
  }
}

}  // namespace

REPRO_EXPORT int bvh_knn_rope_launch(const void* node_lo, const void* node_hi,
                                     const void* rope, const void* left,
                                     const void* perm, const void* queries,
                                     int n, int q, int dim, int k,
                                     void* dists, void* idxs, void* stream) {
  Tree t{static_cast<const float*>(node_lo), static_cast<const float*>(node_hi),
         static_cast<const int*>(rope), static_cast<const int*>(left),
         static_cast<const int*>(perm), n, dim};
  auto qp = static_cast<const float*>(queries);
  auto d = static_cast<float*>(dists);
  auto ix = static_cast<int*>(idxs);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (q + kThreads - 1) / kThreads;
  if (k <= 1) rope_knn_kernel<1><<<blocks, kThreads, 0, s>>>(t, qp, q, k, d, ix);
  else if (k <= 16) rope_knn_kernel<16><<<blocks, kThreads, 0, s>>>(t, qp, q, k, d, ix);
  else if (k <= 32) rope_knn_kernel<32><<<blocks, kThreads, 0, s>>>(t, qp, q, k, d, ix);
  else rope_knn_kernel<256><<<blocks, kThreads, 0, s>>>(t, qp, q, k, d, ix);
  return static_cast<int>(cudaGetLastError());
}
"""

ROPE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3

# the counting build: node tests per query, the queries that take the
# tie pass and its node tests, summed over the launch by atomics
_COUNTERS = r"""
__device__ unsigned long long g_knn_counts[3];  // tests, tie queries, tie tests
"""
_COUNTERS_ENTRY = r"""
REPRO_EXPORT int knn_counters(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_knn_counts,
                                         sizeof(g_knn_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[3] = {0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_knn_counts, zero,
                                             sizeof(zero)));
}
"""


def walk_sources(src):
    """{variant: source} of bvh_traverse.cu."""
    import walk_variants as WV
    counted = WV._edit(src, '#include "knn_list.cuh"\n',
                       '#include "knn_list.cuh"\n' + _COUNTERS)
    # every key the walk takes (knn_walk.cuh) is one node test; those
    # after the walk proper are the tie pass's
    counted = WV._edit(counted, "  int dim;\n  __device__ __forceinline__ "
                       "float key(int m, int& link, int& rope) const {\n",
                       "  int dim;\n  mutable unsigned long long tests = 0;\n"
                       "  __device__ __forceinline__ float key(int m, int& "
                       "link, int& rope) const {\n    ++tests;\n")
    counted = WV._edit(counted, "  knn::nearest_first(keys, n, k, best, "
                       "lost);\n",
                       "  knn::nearest_first(keys, n, k, best, lost);\n"
                       "  const unsigned long long walk_tests = keys.tests;\n")
    counted = WV._edit(counted, "    od[j] = sqrtf(d2);\n    oi[j] = p < 0 ? "
                       "-1 : __ldg(perm + p);\n  });\n",
                       "    od[j] = sqrtf(d2);\n    oi[j] = p < 0 ? -1 : "
                       "__ldg(perm + p);\n  });\n"
                       "  atomicAdd(g_knn_counts, walk_tests);\n"
                       "  atomicAdd(g_knn_counts + 1, keys.tests > walk_tests "
                       "? 1ull : 0ull);\n"
                       "  atomicAdd(g_knn_counts + 2, keys.tests - walk_tests);"
                       "\n")
    return {"rope_walk": src + ROPE_WALK, "counted": counted + _COUNTERS_ENTRY}


def bf_sources(src):
    """{variant: source} of bruteforce_knn.cu."""
    import walk_variants as WV
    return {
        "one_query": WV._edit(src, "kQueriesPerThread = List::kSlots <= 32 "
                              "? 2 : 1;", "kQueriesPerThread = 1;"),
        "parent_threads": WV._edit(
            WV._edit(src, "constexpr int kThreads = 128;",
                     "constexpr int kThreads = 64;"),
            "kQueriesPerThread = List::kSlots <= 32 ? 2 : 1;", "kQueriesPerThread = 1;"),
        "no_queue": WV._edit(src, "if (__any_sync(0xffffffffu, full)) {",
                             "if (__any_sync(0xffffffffu, true)) {"),
        "ptx_max": WV._edit(src, "  return max_nan(__fadd_rn(__fsub_rn(q2, "
                            "__fmul_rn(2.0f, qp)), p.w), 0.0f);",
                            "  float r;\n  asm(\"max.NaN.f32 %0, %1, %2;\" : "
                            "\"=f\"(r) : \"f\"(__fadd_rn(__fsub_rn(q2, "
                            "__fmul_rn(2.0f, qp)), p.w)), \"f\"(0.0f));\n"
                            "  return r;"),
        "register_lists": WV._edit(WV._edit(
            WV._edit(WV._edit(src, "launch<DIM, KeyHeap<16, false>>(a)",
                              "launch<DIM, knn::KeyList<16, false>>(a)"),
                     "launch<DIM, KeyHeap<32, false>>(a)",
                     "launch<DIM, knn::KeyList<32, false>>(a)"),
            "  if (a.k <= 16)", "  if (a.k <= 8) return launch<DIM, "
            "knn::KeyList<8, false>>(a);\n  if (a.k <= 16)"),
            "kQueriesPerThread = List::kSlots <= 32 ? 2 : 1;", "kQueriesPerThread = 1;"),
    }


def knn_phase(card, libs):
    import torch
    import chip_smoke as smoke
    import walk_variants as WV
    from repro_torch.core import geometry as G
    from repro_torch.core import lbvh as L
    from repro_torch.core import morton as M
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_traverse as TT
    from repro_torch.kernels import morton as KM
    from repro_torch.kernels.bvh_traverse import _stream

    dev = torch.device("cuda", 0)
    pts, _, _, qc = smoke.make_data(dev)
    t = L.build(G.Boxes(pts, pts))
    rec = t.records
    n = t.num_leaves
    committed = _build.function("bvh_traverse", "bvh_knn_launch",
                                TT._KNN_ARGS)
    rope = WV.entry(libs["rope_walk"], "bvh_knn_rope_launch", ROPE_ARGS)
    counted = WV.entry(libs["counted"], "bvh_knn_launch", TT._KNN_ARGS)
    counters = WV.entry(libs["counted"], "knn_counters", [ctypes.c_void_p])
    tree = (t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm)

    def walk(fn, queries, k, records, order):
        q = queries.shape[0]
        d = torch.empty((q, k), dtype=torch.float32, device=dev)
        i = torch.empty((q, k), dtype=torch.int32, device=dev)

        def run():
            err = fn(*(a.data_ptr() for a in tree),
                     None if records is None else records.data_ptr(),
                     None if order is None else order.data_ptr(),
                     queries.data_ptr(), n, q, 3, k, d.data_ptr(),
                     i.data_ptr(), _stream(dev))
            if err:
                raise SystemExit(f"knn_variants: launch refused ({err})")
            return d, i

        return run

    def rope_walk(queries, k):
        q = queries.shape[0]
        d = torch.empty((q, k), dtype=torch.float32, device=dev)
        i = torch.empty((q, k), dtype=torch.int32, device=dev)

        def run():
            err = rope(*(a.data_ptr() for a in tree), queries.data_ptr(), n,
                       q, 3, k, d.data_ptr(), i.data_ptr(), _stream(dev))
            if err:
                raise SystemExit(f"knn_variants: launch refused ({err})")
            return d, i

        return run

    def morton(queries):
        codes = KM.morton64(queries, t.node_lo[0].contiguous(),
                            t.node_hi[0].contiguous())
        aux = torch.arange(queries.shape[0], dtype=torch.int32, device=dev)
        return M.sort_by_morton(codes, aux)[1]

    def compare(label, variants, reps):
        runs, ref = [], None
        for name, run in variants:
            got = [a.clone() for a in run()]
            torch.cuda.synchronize()
            if ref is None:
                ref = got
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"knn_variants: {label} {name} differs from "
                                 "committed")
            runs.append((name, run))
        for name, ms in WV.in_turns(runs, reps=reps).items():
            print(f"[variants] {label} {name}: {ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"identical to committed  [{card}]", flush=True)

    def visits(label, queries, k, order):
        buf = (ctypes.c_ulonglong * 3)()
        counters(ctypes.addressof(buf))           # zero them
        walk(counted, queries, k, rec, order)()
        torch.cuda.synchronize()
        if counters(ctypes.addressof(buf)):
            raise SystemExit("knn_variants: knn_counters failed")
        q = queries.shape[0]
        print(f"[variants] {label}: {buf[0] / q:.1f} node tests per query, "
              f"{buf[1]} queries took the tie pass ({buf[2]} node tests "
              "there)", flush=True)

    k = smoke.K
    order = morton(qc)
    order_ms = smoke.time_ms(lambda: morton(qc), reps=5)
    compare(f"walk N={n} Q={qc.shape[0]} k={k}",
            [("committed", walk(committed, qc, k, rec, None)),
             ("morton_order", walk(committed, qc, k, rec, order)),
             ("no_records", walk(committed, qc, k, None, None)),
             ("parent_rope_walk", rope_walk(qc, k))], reps=5)
    print(f"[variants] walk: the Morton order step {order_ms:.4f} ms",
          flush=True)
    visits(f"walk Q={qc.shape[0]} k={k} caller order", qc, k, None)
    compare(f"self walk N=Q={n} k={k}",
            [("committed_leaf_order", walk(committed, pts, k, rec,
                                           t.leaf_perm)),
             ("caller_order", walk(committed, pts, k, rec, None)),
             ("parent_rope_walk", rope_walk(pts, k))], reps=3)
    visits(f"self walk N=Q={n} k={k} leaf order", pts, k, t.leaf_perm)
    for kb in BUCKETS:
        # the rope walk takes some 45 s at k = 256 and Q = 2^17
        qs = qc if kb < 256 else qc[:PARENT_Q_256]
        compare(f"walk N={n} Q={qs.shape[0]} k={kb}",
                [("committed", walk(committed, qs, kb, rec, None)),
                 ("parent_rope_walk", rope_walk(qs, kb))], reps=2)
        visits(f"walk Q={qc.shape[0]} k={kb}", qc, kb, None)
    compare(f"walk N={n} Q={qc.shape[0]} k=256",
            [("committed", walk(committed, qc, 256, rec, None))], reps=2)


def bf_phase(card, libs):
    import torch
    import chip_smoke as smoke
    import walk_variants as WV
    from repro_torch.kernels import _build
    from repro_torch.kernels.bvh_traverse import _stream
    KB = smoke._bf_module()

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pts, _, _, qc = smoke.make_data(dev)
    committed = _build.function("bruteforce_knn", "bruteforce_knn_launch",
                                KB._ARGS)
    one, parent, no_queue, ptx_max, reg_lists = (
        WV.entry(libs[name], "bruteforce_knn_launch", KB._ARGS)
        for name in ("one_query", "parent_threads", "no_queue", "ptx_max",
                     "register_lists"))

    def scan(fn, q, p, k, tail, chunk):
        nq, n = q.shape[0], p.shape[0]
        s = KB.splits(n, tail, chunk)
        d = torch.empty((nq, k), dtype=torch.float32, device=dev)
        i = torch.empty((nq, k), dtype=torch.int32, device=dev)
        pd = pi = None
        if s > 1:
            pd = torch.empty((s, k, nq), dtype=torch.float32, device=dev)
            pi = torch.empty((s, k, nq), dtype=torch.int32, device=dev)

        def run():
            err = fn(q.data_ptr(), p.data_ptr(), nq, n, q.shape[1], k, tail,
                     chunk, d.data_ptr(), i.data_ptr(),
                     None if pd is None else pd.data_ptr(),
                     None if pi is None else pi.data_ptr(), _stream(dev))
            if err:
                raise SystemExit(f"knn_variants: launch refused ({err})")
            return d, i

        return run, s

    for label, q, p, k in (
            (f"bruteforce Q={smoke.Q_BF} N={smoke.N} k={smoke.K}",
             qc[:smoke.Q_BF].contiguous(), pts, smoke.K),
            ("bruteforce Q=1024 N=65536 k=256", qc[:1024].contiguous(),
             pts[:1 << 16].contiguous(), 256)):
        n = p.shape[0]
        tail = KB.tail_from(n, 512)
        chunk = KB.plan(q.shape[0], n, k, tail, sms)
        half = max(KB.TILE, chunk // 2 // KB.TILE * KB.TILE)
        variants = [("committed", committed, chunk),
                    ("quarter_splits", committed, 4 * chunk),
                    ("half_splits", committed, 2 * chunk),
                    ("double_splits", committed, half),
                    ("register_lists", reg_lists, chunk),
                    ("no_queue", no_queue, chunk),
                    ("ptx_max", ptx_max, chunk),
                    ("one_query", one, chunk),
                    ("parent_design", parent, n)]
        runs, ref = [], None
        for name, fn, c in variants:
            run, s = scan(fn, q, p, k, tail, c)
            got = [a.clone() for a in run()]
            torch.cuda.synchronize()
            if ref is None:
                ref = got
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"knn_variants: {label} {name} differs from "
                                 "committed")
            runs.append((f"{name} (S = {s}, chunk {c})", run))
        for name, ms in WV.in_turns(runs, reps=3).items():
            print(f"[variants] {label} {name}: {ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"identical to committed  [{card}]", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("knn_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import walk_variants as WV
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[variants] {card}", flush=True)
    walk_src = open(os.path.join(_build.CSRC, "bvh_traverse.cu")).read()
    bf_src = open(os.path.join(_build.CSRC, "bruteforce_knn.cu")).read()
    sources = {**walk_sources(walk_src), **bf_sources(bf_src)}
    _build.build_all(("bvh_traverse", "bruteforce_knn", "morton"))
    libs = WV.build(sources, show=("knn_kernel<Records3, KeyList 16>",
                                   "scan_kernel<dim 3, KeyList 16>"),
                    out=OUT)
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)
    if "bf" not in sys.argv[1:]:
        knn_phase(card, libs)
    if "walk" not in sys.argv[1:]:
        bf_phase(card, libs)
    print(f"[variants] done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
