#!/usr/bin/env python3
"""Time design variants of the fine kNN walk (``bvh_traverse_fine_knn``,
``csrc/fine_knn.cu``) on one CUDA card, in turns, on ``chip_smoke.py``'s
five nearest queries (Q = 2^17 uniform points over 2^20 triangles at
k = 10 and 1, 2^20 segments at k = 10 and 1, 2^20 spheres at k = 10).

    python3 scripts/fine_knn_variants.py    # from the checkout root

Each variant is either a text edit of the committed
``src/repro_torch/csrc/fine_knn.cu``, built with the port's nvcc flags
into ``build/fine_knn_variants/`` and called through the package wrapper
with its library in place of the committed one, or the committed library
called with other inputs:

  committed     nearest first, one thread a query, the caller's order,
                the rope walk re-walking the flagged queries
  morton_order  the queries sorted by the 64-bit Morton code of their
                points in the tree's root box before the call (the kernel
                timed on the sorted queries; the order step timed apart;
                the rows put back before the comparison)
  block_128     128-thread blocks in place of 256 (an edit)
  warp_query    one warp a query (an edit): every lane walks the query
                with the same list and stack; where a triangle leaf
                takes its edges, three lanes of each four take the three
                segments at once and exchange them by shuffles (the node
                records give a right child only through its left
                sibling's rope, so the two children's loads cannot be
                shared)
  rope_walk     the parent's design: the rope walk alone over every query
                (``bvh_traverse_fine_knn_rope``)

Every variant is first held bit-identical to the rope walk (the twin's
lists), then timed by CUDA events, the variants in one order and then in
the reverse one; each line gives both times. A counting build (an edit
that sums node visits with atomics) gives the visits per query of the
walk and of its certificate and tie pass, and the queries that took the
tie pass; the committed call's counter gives the flagged queries. Needs
one card; exits nonzero without one.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUT = os.path.join(ROOT, "build", "fine_knn_variants")
#: chip_smoke.py's nearest queries of the geometry phase: (values, k)
QUERIES = (("triangles", 10), ("triangles", 1), ("segments", 10),
           ("spheres", 10), ("segments", 1))

# the counting build: node visits (keys taken) of the walk proper, of
# its certificate and tie pass, and the queries that ran the tie pass,
# summed over a launch by atomics
_COUNTERS = r"""
__device__ unsigned long long g_fine_counts[3];
"""
_COUNTERS_ENTRY = r"""
REPRO_EXPORT int fine_counters(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_fine_counts,
                                         sizeof(g_fine_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[3] = {0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_fine_counts, zero,
                                             sizeof(zero)));
}
"""


# one warp a query: every lane walks the same query with the same list
# and stack; of a triangle leaf that takes the edges, lanes 1-3 of each
# group of four take the three segments at once (a runtime choice of the
# endpoints and of the dot products' order, so the lanes run one code),
# exchanged by shuffles
WARP = r"""
template <class P, class A, class B>
__device__ __forceinline__ float segment_rt(P p, A a, B b, bool fused) {
  auto ab = [&](int c) { return b(c) - a(c); };
  auto pa = [&](int c) { return p(c) - a(c); };
  auto dot = [&](auto x, auto y) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float u = x(c), v = y(c);
      s = c == 0 ? u * v + 0.0f : (fused ? __fmaf_rn(u, v, s) : s + u * v);
    }
    return s;
  };
  const float den = max_nan(dot(ab, ab), 1e-30f);
  const float t = pt::clamp01(dot(pa, ab) / den);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g = p(c) - __fmaf_rn(t, ab(c), a(c));
    s = c == 0 ? g * g : __fmaf_rn(g, g, s);
  }
  return sqrtf(s);
}

template <class Nodes>
struct WarpFineWalk : FineWalk<Nodes> {
  __device__ __forceinline__ float leaf(int pos, int link, float kb) const {
    if constexpr (Nodes::N == 3) {
      if (this->vals.kind == kTriangles) {
        float w[3][3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          xyz_of(__ldg(this->vals.rec + 3LL * pos + j), w[j]);
        }
        auto q = [&](int c) { return this->qc[c]; };
        auto va = [&](int c) { return w[0][c]; };
        auto vb = [&](int c) { return w[1][c]; };
        auto vc = [&](int c) { return w[2][c]; };
        float v, ww;
        pt::barycentric<true, 3>(q, va, vb, vc, 3, v, ww);
        if (v >= 0.0f && ww >= 0.0f && v + ww <= 1.0f) {
          return pt::triangle<3>(q, va, vb, vc, 3);
        }
        const int lane = threadIdx.x & 31;
        const int part = lane & 3;   // 1: (a, b), 2: (b, c), 3: (a, c)
        auto x0 = [&](int c) { return part == 2 ? w[1][c] : w[0][c]; };
        auto x1 = [&](int c) { return part == 1 ? w[1][c] : w[2][c]; };
        const float s = segment_rt(q, x0, x1, part != 2);
        const int g = lane & ~3;
        const float s_ab = __shfl_sync(0xffffffffu, s, g | 1);
        const float s_bc = __shfl_sync(0xffffffffu, s, g | 2);
        const float s_ac = __shfl_sync(0xffffffffu, s, g | 3);
        return min_nan(s_ab, min_nan(s_bc, s_ac));
      }
    }
    return FineWalk<Nodes>::leaf(pos, link, kb);
  }
};

template <class Nodes, class List>
__global__ void __launch_bounds__(kThreads)
    fine_nf_warp_kernel(Nodes nodes, Values vals, const int* __restrict__ perm,
                        int n, int dim, Query qs,
                        const float* __restrict__ rneg, int q, int k,
                        float* __restrict__ dists, int* __restrict__ idxs,
                        int* __restrict__ flagged) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const bool lead = (threadIdx.x & 31) == 0;
  if (qi >= q) return;
  WarpFineWalk<Nodes> walk{{nodes, vals, dim, qs.radius,
                            qs.radius == nullptr ? 0.0f
                                                 : __ldg(qs.radius + qi)}};
  walk.load_query(qs.q_lo, qs.q_hi, qs.center, qi);
  const float slack2 = __fmul_ru(2.0f, walk.slack(rneg));
  List best;
  float lost, lost_anom;
  fine_nearest_first(walk, n, k, slack2, best, lost, lost_anom);
  if (fine_flagged(walk, n, k, slack2, best, lost, lost_anom)) {
    if (lead) flagged[1 + atomicAdd(flagged, 1)] = qi;
    return;
  }
  float* od = dists + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
  fine_tie_pass_and_put(walk, n, k, best, lost, [&](int j, float d, int p) {
    if (lead) {
      od[j] = d;
      oi[j] = p < 0 ? -1 : __ldg(perm + p);
    }
  });
}

"""


def sources(src):
    """{variant: source} of fine_knn.cu."""
    import walk_variants as WV
    warp = WV._edit(src, "struct Call {\n", WARP + "struct Call {\n")
    warp = WV._edit(warp, "      fine_nf_kernel<Nodes, List><<<blocks, kThreads, "
                    "0, c.stream>>>(",
                    "      fine_nf_warp_kernel<Nodes, List><<<blocks * 32, "
                    "kThreads, 0, c.stream>>>(")
    counted = WV._edit(src, '#include "rope_knn.cuh"\n',
                       '#include "rope_knn.cuh"\n' + _COUNTERS)
    counted = WV._edit(counted, "  float lo[N], hi[N];\n",
                       "  float lo[N], hi[N];\n"
                       "  unsigned long long visits = 0;\n")
    counted = WV._edit(counted, "  __device__ __forceinline__ float key(int m, "
                       "int& link, int& rope) {\n",
                       "  __device__ __forceinline__ float key(int m, "
                       "int& link, int& rope) {\n    ++visits;\n")
    counted = WV._edit(counted, "  fine_nearest_first(walk, n, k, slack2, best, "
                       "lost, lost_anom);\n",
                       "  fine_nearest_first(walk, n, k, slack2, best, "
                       "lost, lost_anom);\n"
                       "  atomicAdd(g_fine_counts, walk.visits);\n"
                       "  const unsigned long long v0 = walk.visits;\n")
    counted = WV._edit(counted, "    oi[j] = p < 0 ? -1 : __ldg(perm + p);\n"
                       "  });\n}\n",
                       "    oi[j] = p < 0 ? -1 : __ldg(perm + p);\n  });\n"
                       "  atomicAdd(g_fine_counts + 1, walk.visits - v0);\n"
                       "  if (lost == best.bound() && best.bound() != "
                       "INFINITY) atomicAdd(g_fine_counts + 2, 1ull);\n}\n")
    return {"counted": counted + _COUNTERS_ENTRY,
            "block_128": WV._edit(src, "constexpr int kThreads = 256;",
                                  "constexpr int kThreads = 128;"),
            "warp_query": warp}


@contextlib.contextmanager
def library(lib):
    """The package wrapper with `lib`'s entry points in place of the
    committed library's."""
    import walk_variants as WV
    from repro_torch.kernels import _build
    real = _build.function
    _build.function = lambda name, fn, argtypes: WV.entry(lib, fn, argtypes)
    try:
        yield
    finally:
        _build.function = real


def counted_visits(lib, call, q):
    """(walk visits a query, certificate and tie-pass visits a query,
    queries that took the tie pass) of one call through the counting
    build `lib`."""
    import torch
    import walk_variants as WV
    counters = WV.entry(lib, "fine_counters", [ctypes.c_void_p])
    buf = (ctypes.c_ulonglong * 3)()
    counters(ctypes.addressof(buf))              # zero them
    with library(lib):
        call()
    torch.cuda.synchronize()
    if counters(ctypes.addressof(buf)):
        raise SystemExit("fine_knn_variants: fine_counters failed")
    return buf[0] / q, buf[1] / q, buf[2]


def build_counted(out=OUT):
    """The counting build of the committed source (one nvcc), as a ctypes
    library."""
    import walk_variants as WV
    from repro_torch.kernels import _build
    src = open(os.path.join(_build.CSRC, "fine_knn.cu")).read()
    return WV.build({"counted": sources(src)["counted"]}, show=(),
                    out=out)["counted"]


def main():
    import torch
    if not torch.cuda.is_available():
        print("fine_knn_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    import walk_variants as WV
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import morton as M
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import morton as KM

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[variants] {card}", flush=True)
    src = open(os.path.join(_build.CSRC, "fine_knn.cu")).read()
    _build.build_all(("fine_knn", "morton", "karras", "lbvh_tail"))
    libs = WV.build(sources(src), show=("fine_nf_kernel<Records3, KeyList",
                                        "fine_nf_warp_kernel"), out=OUT)
    for fn, regs, spill in smoke._ptxas_summary(_build.build_log("fine_knn")):
        if "Records3" in fn:
            print(f"[variants] committed {fn}: {regs} registers, {spill} B "
                  "spill stores", flush=True)
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    soup, spheres, segs, pq = smoke.geometry_scenes(dev)
    policy = rt.ExecutionPolicy(device=dev)
    index = {"triangles": rt.BVH(soup, policy=policy),
             "segments": rt.BVH(segs, policy=policy),
             "spheres": rt.BVH(spheres, policy=policy)}
    points = G.Points(pq)
    q = pq.shape[0]
    for kind, k in QUERIES:
        ix = index[kind]
        t_ = ix.tree
        tree = (t_.node_lo, t_.node_hi, t_.rope, t_.left_child, t_.leaf_perm)
        kept = dict(records=t_.records, value_records=ix.value_records)

        def order_of():
            codes = KM.morton64(pq, t_.node_lo[0].contiguous(),
                                t_.node_hi[0].contiguous())
            aux = torch.arange(q, dtype=torch.int32, device=dev)
            return M.sort_by_morton(codes, aux)[1].to(torch.int64)

        order = order_of()
        sorted_points = G.Points(pq[order].contiguous())

        def walk(pts):
            return lambda: T.bvh_traverse_fine_knn(*tree, ix.values, pts,
                                                   k=k, **kept)

        def with_lib(lib):
            def run():
                with library(lib):
                    return walk(points)()
            return run

        rope = lambda: T.bvh_traverse_fine_knn_rope(*tree, ix.values, points,
                                                    k=k, **kept)
        want = [x.clone() for x in rope()]
        label = f"{kind} k={k} N={len(ix.values)} Q={q}"
        got = walk(points)()
        flags = int(T.bvh_traverse_fine_knn.flagged.item())
        checks = {"committed": got, "block_128": with_lib(libs["block_128"])(),
                  "warp_query": with_lib(libs["warp_query"])()}
        sd, si = walk(sorted_points)()
        back = [torch.empty_like(sd), torch.empty_like(si)]
        back[0][order], back[1][order] = sd, si
        checks["morton_order"] = back
        for name, (d, i) in checks.items():
            if not (torch.equal(d, want[0]) and torch.equal(i, want[1])):
                raise SystemExit(f"fine_knn_variants: {label} {name} differs "
                                 "from the rope walk")
        runs = [("committed", walk(points)),
                ("morton_order", walk(sorted_points)),
                ("block_128", with_lib(libs["block_128"])),
                ("warp_query", with_lib(libs["warp_query"])),
                ("rope_walk", rope)]
        for name, ms in WV.in_turns(runs, reps=3).items():
            print(f"[variants] {label} {name}: {ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"identical to the rope walk  [{card}]", flush=True)
        order_ms = smoke.time_ms(order_of, reps=5)
        walk_v, extra_v, tie_q = counted_visits(libs["counted"],
                                                walk(points), q)
        print(f"[variants] {label}: {walk_v:.1f} node visits a query in the "
              f"walk, {extra_v:.2f} in the certificate and the tie pass; "
              f"{tie_q} queries took the tie pass, {flags} were flagged and "
              f"re-walked; the Morton order step {order_ms:.3f} ms", flush=True)
        del want, got, checks, back
    print(f"[variants] done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
