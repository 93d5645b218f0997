#!/usr/bin/env python3
"""Time design variants of the spatial walk (``bvh_traverse_spatial``) and
of the Karras ranges (``karras_ranges``) on one CUDA card, in turns.

    python3 scripts/spatial_variants.py [spatial | karras] [--parent DIR]
                     # from the checkout root; one phase, or both

Each variant is either a text edit of the committed
``src/repro_torch/csrc/bvh_traverse.cu`` or ``karras.cu``, built with the
port's nvcc flags into ``build/spatial_variants/``, or the committed
library called through its C entry point with other arguments. The data
is ``chip_smoke.py``'s: 2^20 uniform points (and boxes of side 0.01),
Q = 2^17 sphere queries of radius 0.0132.

  spatial walk (Points values with the sqrt leaf test, cap 28; Boxes
  values, cap 64): the fill alone, then count (cap 1) + fill
    committed        spatial_kernel3: node records, range_last only under
                     a min_pos filter (none here), the leaf test from the
                     node test, the caller's order
    arrays           the flat-array instance (records null)
    range_last       every internal node reads range_last (an edit)
    gathered_leaf    each leaf reads its box from the flat arrays and its
                     index through leaf_perm, and tests again (an edit)
    morton_order     the query centres' Morton order (the morton64 kernel
                     in the tree's root box, then one sort), its step
                     timed with the count + fill
    parent           with ``--parent DIR``: the ``bvh_traverse.cu`` of
                     another checkout (``git archive`` of the parent
                     commit unpacked into DIR), through its own C entry
  the self query (the 2^20 points as sphere centres, Q = N): the caller's
  order against the tree's leaf order, count + fill.
  Karras ranges (the sorted Morton keys of the 2^20 points)
    committed        int64 lanes read in place, bounded searches; through
                     the wrapper and the kernel alone
    fixed            the searches from max_log2, as before (an edit)
    u32_arrays       three uint32 arrays made by three conversions, as
                     the parent's wrapper did (an edit; the conversions
                     timed with it)
    packed           one pass packs (hi, lo, idx, 0) into 16 bytes a leaf,
                     then one vector load a probe (an appended kernel with
                     its own C entry; the pass timed with it)
    parent           with ``--parent DIR``: the parent's ``karras.cu``
                     with its wrapper's conversions
  and the mean probes a node makes under the bounded searches.

Each variant is first held identical to the committed kernel, then timed
by CUDA events; the variants run in one order and then in the reverse
one, and each line gives both times. Needs one card; exits nonzero
without one.
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

OUT = os.path.join(ROOT, "build", "spatial_variants")

# the packed-key Karras kernel: the committed kernel's text over a 16-byte
# record per leaf, with the pass that packs them
PACKED = r"""
namespace {

struct Packed {
  const int4* __restrict__ k;
  int n;
  __device__ __forceinline__ Key at(long long j) const {
    const int4 v = __ldg(k + j);
    return Key{static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
               static_cast<uint32_t>(v.z)};
  }
  __device__ __forceinline__ int delta(const Key& ki, long long j) const {
    if (j < 0 || j > n - 1) return -1;
    const Key kj = at(j);
    const uint32_t hx = ki.hi ^ kj.hi;
    const uint32_t lx = ki.lo ^ kj.lo;
    if (hx != 0) return __clz(static_cast<int>(hx));
    if (lx != 0) return 32 + __clz(static_cast<int>(lx));
    return 64 + __clz(static_cast<int>(ki.idx ^ kj.idx));
  }
};

__global__ void pack_keys(const long long* __restrict__ hi,
                          const long long* __restrict__ lo,
                          const long long* __restrict__ idx, int n,
                          int4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = make_int4(static_cast<int>(hi[i]), static_cast<int>(lo[i]),
                     static_cast<int>(idx[i]), 0);
}

@KERNEL@
}  // namespace

REPRO_EXPORT int karras_packed_launch(const void* hi, const void* lo,
                                      const void* idx, int n, void* scratch,
                                      void* first, void* last, void* gamma,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto rec = static_cast<int4*>(scratch);
  pack_keys<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const long long*>(hi), static_cast<const long long*>(lo),
      static_cast<const long long*>(idx), n, rec);
  karras_packed_kernel<<<(n - 1 + 255) / 256, 256, 0, s>>>(
      Packed{rec, n}, static_cast<int*>(first), static_cast<int*>(last),
      static_cast<int*>(gamma));
  return static_cast<int>(cudaGetLastError());
}
"""

# the gathered leaf test: the flat leaf box and leaf_perm, read at a leaf
GATHER_GLOBALS = r"""
__device__ const float* g_node_lo;
__device__ const float* g_node_hi;
__device__ const int* g_perm;
"""
GATHER_ENTRY = r"""
REPRO_EXPORT int set_leaf_arrays(const void* lo, const void* hi,
                                 const void* perm) {
  cudaError_t e = cudaMemcpyToSymbol(g_node_lo, &lo, sizeof(lo));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_node_hi, &hi, sizeof(hi));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_perm, &perm, sizeof(perm));
  return static_cast<int>(e);
}
"""
LEAF_TEST = """    if (reach && node - n1 > mp && (!kFineSqrt || sqrtf(d2) <= r)) {
      if (cnt < cap) out[cnt] = b.w;
      ++cnt;
    }
"""
GATHERED_LEAF_TEST = """    {
      const float* vl = g_node_lo + static_cast<long long>(node) * 3;
      const float* vh = g_node_hi + static_cast<long long>(node) * 3;
      float e2 = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g = max_nan(max_nan(ql[c] - __ldg(vh + c),
                                        __ldg(vl + c) - qh[c]), 0.0f);
        e2 = c == 0 ? g * g : __fmaf_rn(g, g, e2);
      }
      if (e2 <= r2 && node - n1 > mp && (!kFineSqrt || sqrtf(e2) <= r)) {
        if (cnt < cap) out[cnt] = __ldg(g_perm + (node - n1));
        ++cnt;
      }
    }
"""

PARENT_SPATIAL_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
PARENT_KARRAS_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p] * 4)
PACKED_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5


def spatial_sources(src):
    import walk_variants as WV
    gathered = WV._edit(src, '#include "knn_walk.cuh"\n',
                        '#include "knn_walk.cuh"\n' + GATHER_GLOBALS)
    gathered = WV._edit(gathered, LEAF_TEST, GATHERED_LEAF_TEST)
    return {
        "range_last": WV._edit(
            src, "node = reach && (mp < 0 || __ldg(range_last + node) > mp) "
            "? b.w : a.w;", "node = reach && __ldg(range_last + node) > mp "
            "? b.w : a.w;"),
        "gathered_leaf": gathered + GATHER_ENTRY,
    }


def karras_sources(src):
    import walk_variants as WV
    ml2 = "max(32 - __clz(k.n - 1), 1)"
    fixed = WV._edit(src, "  long long l_max = 2;\n  while (k.delta(ki, i + "
                     "l_max * d) > delta_min) l_max <<= 1;\n",
                     f"  const long long l_max = 2LL << {ml2};\n")
    fixed = WV._edit(fixed, "for (int t = l > 0 ? 1 << (31 - __clz(l)) : 0; "
                     "t > 0; t >>= 1) {", f"for (int t = 1 << {ml2}; t > 0; "
                     "t >>= 1) {")
    body = src[src.index("__global__ void karras_kernel("):
               src.index("}  // namespace")]
    kernel = WV._edit(body, "karras_kernel(Keys k", "karras_packed_kernel("
                      "Packed k")
    return {
        "fixed": fixed,
        "u32_arrays": WV._edit(src, "using Lane = long long;",
                               "using Lane = unsigned int;"),
        "packed": src + PACKED.replace("@KERNEL@", kernel),
    }


def spatial_phase(card, libs):
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
    pts, box_lo, box_hi, qc = smoke.make_data(dev)
    committed = _build.function("bvh_traverse", "bvh_spatial_launch",
                                TT._SPATIAL_ARGS)
    edited = {name: WV.entry(libs[name], "bvh_spatial_launch",
                             TT._SPATIAL_ARGS)
              for name in ("range_last", "gathered_leaf")}
    set_leaf = WV.entry(libs["gathered_leaf"], "set_leaf_arrays",
                        [ctypes.c_void_p] * 3)
    parent = (WV.entry(libs["parent_spatial"], "bvh_spatial_launch",
                       PARENT_SPATIAL_ARGS) if "parent_spatial" in libs
              else None)

    def launcher(fn, t, queries, cap, fine, records, order=None,
                 old_entry=False):
        q = queries.shape[0]
        r = torch.full((q,), smoke.RADIUS, device=dev)
        counts = torch.empty((q,), dtype=torch.int32, device=dev)
        buf = torch.full((q, cap), -1, dtype=torch.int32, device=dev)
        mp = torch.full((q,), -1, dtype=torch.int32, device=dev)
        tree = [a.data_ptr() for a in (t.node_lo, t.node_hi, t.rope,
                                       t.left_child, t.range_last,
                                       t.leaf_perm)]
        n = t.num_leaves

        def run():
            if old_entry:
                err = fn(*tree, queries.data_ptr(), queries.data_ptr(),
                         r.data_ptr(), mp.data_ptr(), n, q, 3, cap, int(fine),
                         counts.data_ptr(), buf.data_ptr(), _stream(dev))
            else:
                err = fn(*tree, None if records is None else records.data_ptr(),
                         None if order is None else order.data_ptr(),
                         queries.data_ptr(), queries.data_ptr(), r.data_ptr(),
                         None, n, q, 3, cap, int(fine), counts.data_ptr(),
                         buf.data_ptr(), _stream(dev))
            if err:
                raise SystemExit(f"spatial_variants: launch refused ({err})")
            return counts, buf

        return run

    def morton_order(t, queries):
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
                raise SystemExit(f"spatial_variants: {label} {name} differs "
                                 "from committed")
            runs.append((name, run))
        for name, ms in WV.in_turns(runs, reps=reps).items():
            print(f"[variants] {label} {name}: {ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"identical to committed  [{card}]", flush=True)

    def pair(count, fill, step=None):
        def run():
            if step is not None:
                step()
            count()
            return fill()
        return run

    for label, t, fine in (
            ("points", L.build(G.Boxes(pts, pts)), True),
            ("boxes", L.build(G.Boxes(box_lo, box_hi)), False)):
        rec = t.records
        cnt, _ = TT.bvh_traverse_spatial(
            t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
            t.leaf_perm, qc, qc, torch.full((qc.shape[0],), smoke.RADIUS,
                                            device=dev),
            fine_sqrt=fine, records=rec)
        cap = max(int(cnt.max()), 1)
        if set_leaf(t.node_lo.data_ptr(), t.node_hi.data_ptr(),
                    t.leaf_perm.data_ptr()):
            raise SystemExit("spatial_variants: set_leaf_arrays failed")
        order = morton_order(t, qc)
        step_ms = smoke.time_ms(lambda: morton_order(t, qc), reps=10)
        fill = {"committed": launcher(committed, t, qc, cap, fine, rec),
                "arrays": launcher(committed, t, qc, cap, fine, None),
                "range_last": launcher(edited["range_last"], t, qc, cap, fine,
                                       rec),
                "gathered_leaf": launcher(edited["gathered_leaf"], t, qc, cap,
                                          fine, rec),
                "morton_order": launcher(committed, t, qc, cap, fine, rec,
                                         order)}
        if parent is not None:
            fill["parent"] = launcher(parent, t, qc, cap, fine, None,
                                      old_entry=True)
        compare(f"spatial fill {label} N={t.num_leaves} Q={qc.shape[0]} "
                f"cap={cap}", list(fill.items()), reps=20)
        count1 = launcher(committed, t, qc, 1, fine, rec)
        count1_o = launcher(committed, t, qc, 1, fine, rec, order)
        compare(f"spatial count + fill {label}",
                [("committed", pair(count1, fill["committed"])),
                 ("morton_order_with_step", pair(
                     count1_o, fill["morton_order"],
                     lambda: morton_order(t, qc)))], reps=10)
        print(f"[variants] spatial {label}: the Morton order step "
              f"{step_ms:.4f} ms  [{card}]", flush=True)
        if label == "points":
            cnt, _ = TT.bvh_traverse_spatial(
                t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
                t.leaf_perm, pts, pts, torch.full((pts.shape[0],),
                                                  smoke.RADIUS, device=dev),
                fine_sqrt=True, records=rec)
            scap = max(int(cnt.max()), 1)
            compare(f"spatial self count + fill N=Q={t.num_leaves} "
                    f"cap={scap}",
                    [("caller_order", pair(
                        launcher(committed, t, pts, 1, True, rec),
                        launcher(committed, t, pts, scap, True, rec))),
                     ("leaf_order", pair(
                         launcher(committed, t, pts, 1, True, rec,
                                  t.leaf_perm),
                         launcher(committed, t, pts, scap, True, rec,
                                  t.leaf_perm)))], reps=5)
        del t, rec, fill


def karras_phase(card, libs):
    import torch
    import chip_smoke as smoke
    import walk_variants as WV
    from repro_torch.core import morton as M
    from repro_torch.kernels import _build
    from repro_torch.kernels import lbvh_build as KB

    dev = torch.device("cuda", 0)
    pts = smoke.make_data(dev)[0]
    n = pts.shape[0]
    codes = M.morton64(pts, pts.amin(0), pts.amax(0))
    codes_s, _ = M.sort_by_morton(codes, torch.arange(n, device=dev))
    hi, lo, idx = M.combined_delta_key(codes_s, n)
    ml2 = max((n - 1).bit_length(), 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = [torch.empty((n - 1,), dtype=torch.int32, device=dev)
           for _ in range(3)]
    scratch = torch.empty((n, 4), dtype=torch.int32, device=dev)
    committed = _build.function("karras", "karras_ranges_launch",
                                KB._LAUNCH_ARGS)
    fixed = WV.entry(libs["fixed"], "karras_ranges_launch", KB._LAUNCH_ARGS)
    u32 = WV.entry(libs["u32_arrays"], "karras_ranges_launch",
                   KB._LAUNCH_ARGS)
    packed = WV.entry(libs["packed"], "karras_packed_launch", PACKED_ARGS)

    def as_u32(x):
        return torch.where(x >= (1 << 31), x - (1 << 32),
                           x).to(torch.int32).contiguous()

    def call(fn, keys, *extra):
        err = fn(*(k.data_ptr() for k in keys), n, *extra,
                 *(o.data_ptr() for o in out), stream)
        if err:
            raise SystemExit(f"spatial_variants: launch refused ({err})")
        return out

    lanes = (hi, lo, idx)
    variants = [
        ("committed_wrapper", lambda: KB.karras_ranges(hi, lo, idx, n, ml2)),
        ("committed_kernel", lambda: call(committed, lanes)),
        ("fixed", lambda: call(fixed, lanes)),
        ("u32_arrays_with_conversions",
         lambda: call(u32, [as_u32(k) for k in lanes])),
        ("packed_with_pass", lambda: call(packed, lanes, scratch.data_ptr())),
    ]
    if "parent_karras" in libs:
        parent = WV.entry(libs["parent_karras"], "karras_ranges_launch",
                          PARENT_KARRAS_ARGS)
        variants.append(("parent_with_conversions", lambda: call(
            parent, [as_u32(k) for k in lanes], ml2)))
    runs, ref = [], None
    for name, run in variants:
        got = [a.clone() for a in run()]
        torch.cuda.synchronize()
        if ref is None:
            ref = got
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise SystemExit(f"spatial_variants: karras {name} differs from "
                             "committed")
        runs.append((name, run))
    twin = KB.karras_ranges_fused(hi, lo, idx, n, ml2)
    if not all(torch.equal(a, b) for a, b in zip(ref, twin)):
        raise SystemExit("spatial_variants: karras differs from its twin")
    for name, ms in WV.in_turns(runs, reps=50).items():
        print(f"[variants] karras N={n} {name}: {ms[0]:.4f} / {ms[1]:.4f} "
              f"ms, identical to committed  [{card}]", flush=True)
    length = (ref[1] - ref[0]).to(torch.float64)
    probes = 3 + 3 * (torch.floor(torch.log2(length)) + 1)
    print(f"[variants] karras N={n}: {float(probes.mean()):.3f} probes a node "
          f"on the mean (bounded), {2 * (ml2 + 1) + 3} fixed", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("spatial_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import walk_variants as WV
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[variants] {card}", flush=True)
    sp_src = open(os.path.join(_build.CSRC, "bvh_traverse.cu")).read()
    ka_src = open(os.path.join(_build.CSRC, "karras.cu")).read()
    sources = {**spatial_sources(sp_src), **karras_sources(ka_src)}
    if "--parent" in sys.argv:
        pdir = os.path.join(sys.argv[sys.argv.index("--parent") + 1], "src",
                            "repro_torch", "csrc")
        sources["parent_spatial"] = open(os.path.join(
            pdir, "bvh_traverse.cu")).read()
        sources["parent_karras"] = open(os.path.join(pdir, "karras.cu")).read()
    _build.build_all(("bvh_traverse", "karras", "morton"))
    libs = WV.build(sources, show=("spatial_kernel", "karras"), out=OUT)
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)
    if "karras" not in sys.argv[1:]:
        spatial_phase(card, libs)
    if "spatial" not in sys.argv[1:]:
        karras_phase(card, libs)
    print(f"[variants] done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
