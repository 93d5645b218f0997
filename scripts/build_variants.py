#!/usr/bin/env python3
"""Time the LBVH build on one CUDA card: where a build's time goes, and
the design levers of its two kernels (``csrc/morton.cu`` and
``csrc/lbvh_tail.cu``), in turns.

    python3 scripts/build_variants.py breakdown [--src DIR]
    python3 scripts/build_variants.py levers [--parent DIR]
                     # from the checkout root; needs one card

``breakdown`` builds ``BVH(Points)`` and ``BVH(Boxes)`` over
``chip_smoke.py``'s data (2^20 uniform points, boxes of side 0.01) with
the package under DIR/src (default: this checkout; a ``git archive`` of
another commit unpacked into DIR gives that commit's build) and prints:
the build's time (CUDA events), one build under torch.profiler (every
device kernel in launch order with its device time, the device-busy
share, the idle time between the first and the last kernel, the host
time before the first), the peak device memory of a build (above what
was allocated before it), the first spatial query of a fresh index
(Q = 2^17 spheres of radius 0.0132) beside a repeated one, and the
steps alone on the same inputs: the Morton codes through the plain
PyTorch encoder (``core.morton``), the stable sort of the keys,
``aabb_rmq``'s sparse table, the node records' pack and, through its C
entry with its outputs allocated once, the Morton kernel alone.

``levers`` times each lever of the two kernels against the committed
kernel, each held identical to it first:

  Morton codes (dim 3 and 6, N = 2^20)
    parent           with ``--parent DIR``: that checkout's morton.cu
                     (runtime loops, one point a thread, two lanes)
    loops            the committed kernel with the bit-by-bit runtime
                     loop in place of the mask spread (an edit)
    points2/4        two or four points a thread (16-byte loads where a
                     thread's floats make whole vectors), against one
                     (edits)
    lanes            the stand-alone entry's two lanes on the centroids,
                     then the torch ops that pack them into the sort key,
                     against the build entry's one key from the boxes
  the build's tail (N = 2^20 Points and Boxes)
    rmq              the plain twin's sparse table (``aabb_rmq``), the
                     cat, the ropes and the records' pack, on the card
    fenced           the climb's arrivals as __threadfence, atomicAdd,
                     __threadfence (an edit)
    climb_ropes      the ropes computed in the climb after each arrival
                     (two dependent loads) instead of the rope pass
    bare             the tail kernel without its records (the pack at
                     the first query, timed with it), and the build plus
                     the first query either way

Every variant line gives two times: one order, then the reverse one.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _src_dir():
    if "--src" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
    return ROOT


# the package under test is imported before chip_smoke (which puts this
# checkout's src first on the path) so that --src decides which one runs
sys.path.insert(0, os.path.join(_src_dir(), "src"))
import repro_torch  # noqa: E402,F401
sys.path.insert(1, ROOT)
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

OUT = os.path.join(ROOT, "build", "build_variants")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _profile_build(make, label, card):
    """One call of make() under torch.profiler: the device kernels in
    launch order, busy share, idle time inside the span, host lead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.end > e.time_range.start),
                 key=lambda e: e.time_range.start)
    if not dev:
        print(f"[breakdown] {label}: device time not measured (the "
              "profiler saw no device activity)", flush=True)
        return
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    start = min(e.time_range.start for e in cpu) if cpu else \
        dev[0].time_range.start
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    span = (dev[-1].time_range.end - dev[0].time_range.start) / 1e3
    print(f"[breakdown] {label}: {len(dev)} device kernels, busy {busy:.3f} "
          f"ms of a {wall:.3f} ms window ({100 * busy / wall:.1f} %); first "
          f"kernel to last {span:.3f} ms, idle inside it {span - busy:.3f} "
          f"ms; host before the first kernel "
          f"{(dev[0].time_range.start - start) / 1e3:.3f} ms  [{card}]",
          flush=True)
    prev = None
    for e in dev:
        gap = "" if prev is None else \
            f" (gap {(e.time_range.start - prev) / 1e3:.3f})"
        ms = (e.time_range.end - e.time_range.start) / 1e3
        print(f"[breakdown]   {ms:8.4f} ms{gap}  {e.name[:100]}", flush=True)
        prev = e.time_range.end


def breakdown():
    import torch
    import chip_smoke as smoke
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import morton as M
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM

    card = _card()
    print(f"[breakdown] package {os.path.dirname(repro_torch.__file__)}  "
          f"[{card}]", flush=True)
    dev = torch.device("cuda", 0)
    secs = _build.build_all(tuple(s for s in _build.SOURCES
                                  if s in ("morton", "karras", "lbvh_tail",
                                           "bvh_traverse")))
    print(f"[breakdown] kernels built in {secs:.1f} s", flush=True)
    pts, box_lo, box_hi, qc = smoke.make_data(dev)
    n = smoke.N
    policy = rt.ExecutionPolicy()
    spheres = rt.intersects(G.Spheres(qc, torch.full((smoke.Q,), smoke.RADIUS,
                                                     device=dev)))
    # load the spatial kernel's library before any first query is timed
    rt.BVH(G.Points(pts[:4096]), policy=policy).query(spheres)
    for label, values, lo, hi in (("points", G.Points(pts), pts, pts),
                                  ("boxes", G.Boxes(box_lo, box_hi), box_lo,
                                   box_hi)):
        holder = {}

        def make():
            holder["index"] = rt.BVH(values, policy=policy)

        make()
        make()
        build_ms = smoke.time_ms(make, reps=5)
        print(f"[breakdown] {label} N={n}: build {build_ms:.3f} ms (CUDA "
              f"events, 5 builds after 2)  [{card}]", flush=True)
        _profile_build(make, f"{label} build", card)
        torch.cuda.synchronize()
        del holder["index"]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        make()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[breakdown] {label}: peak device memory of a build "
              f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB above "
              f"the {base / 2**20:.1f} MiB allocated before it", flush=True)
        index = holder["index"]
        _, first_ms = smoke.timed_once(lambda: index.query(spheres))
        again = smoke.time_ms(lambda: index.query(spheres), reps=5)
        print(f"[breakdown] {label}: first spatial query of a fresh index "
              f"{first_ms:.3f} ms, repeated {again:.3f} ms (Q={smoke.Q})",
              flush=True)

        # the steps alone, on this build's inputs
        c = 0.5 * (lo + hi)
        s_lo, s_hi = c.amin(0), c.amax(0)
        twin_ms = smoke.time_ms(lambda: M.morton64(c, s_lo, s_hi), reps=3)
        h, l_ = M.morton64(c, s_lo, s_hi)
        key = ((h - (1 << 31)) << 32) + l_
        sort_ms = smoke.time_ms(lambda: torch.sort(key, stable=True), reps=10)
        perm = torch.sort(key, stable=True).indices
        t = index.tree
        leaf_lo, leaf_hi = lo[perm], hi[perm]
        first, last = t.range_first, t.range_last[:n - 1]
        rmq_ms = smoke.time_ms(lambda: KB.aabb_rmq(
            leaf_lo, leaf_hi, first, last, (n - 1).bit_length()), reps=5)
        pack_ms = smoke.time_ms(lambda: T.pack_nodes(
            t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm), reps=5)
        print(f"[breakdown] {label} steps alone: core.morton.morton64 "
              f"{twin_ms:.3f} ms; torch.sort(stable) of the int64 keys "
              f"{sort_ms:.4f} ms; aabb_rmq {rmq_ms:.4f} ms; pack_nodes "
              f"{pack_ms:.4f} ms  [{card}]", flush=True)

    # the stand-alone Morton kernel: through its wrapper, and its C entry
    # alone on outputs allocated once
    s_lo, s_hi = pts.amin(0), pts.amax(0)
    wrap_ms = smoke.time_ms(lambda: KM.morton64(pts, s_lo, s_hi), reps=50)
    hi_o = torch.empty((n,), dtype=torch.int64, device=dev)
    lo_o = torch.empty((n,), dtype=torch.int64, device=dev)
    fn = _build.function("morton", "morton64_launch", KM._ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (pts.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(), n, 3,
            M.bits_per_dim(3), hi_o.data_ptr(), lo_o.data_ptr(), stream)
    alone_ms = smoke.time_ms(lambda: fn(*args), reps=50)
    prof_ms = smoke.kernel_ms(lambda: fn(*args), ("lanes_kernel",), reps=20) \
        or smoke.kernel_ms(lambda: fn(*args), ("morton_kernel",), reps=20)
    want = KM.morton64(pts, s_lo, s_hi)
    if not (torch.equal(hi_o, want[0]) and torch.equal(lo_o, want[1])):
        raise SystemExit("build_variants: the C entry differs from the wrapper")
    print(f"[breakdown] morton64 N={n} dim 3: through the wrapper "
          f"{wrap_ms:.4f} ms, the C entry alone {alone_ms:.4f} ms, the "
          f"kernel's device time under the profiler "
          f"{'not measured' if prof_ms is None else f'{prof_ms:.4f} ms'}  "
          f"[{card}]", flush=True)


# -- the levers -------------------------------------------------------------

# the unrolled bit-by-bit interleave in place of the mask spread
SPREAD_LOOP = r"""
template <int DIM, int BITS>
__device__ __forceinline__ unsigned long long spread_loop(unsigned q) {
  unsigned long long x = 0;
#pragma unroll
  for (int j = 0; j < BITS; ++j) {
    x |= static_cast<unsigned long long>((q >> j) & 1u) << (j * DIM);
  }
  return x;
}

// the reference's quantization of one coordinate"""


def morton_sources(src):
    import walk_variants as WV
    loop = WV._edit(src, "\n// the reference's quantization of one coordinate",
                    SPREAD_LOOP)
    loop = WV._edit(loop, "code |= spread<DIM, kBits>(", "code |= "
                    "spread_loop<DIM, kBits>(")
    # dim 3 takes the generic kernels: dim and bits at run time, one point
    # a thread, scalar loads
    runtime = WV._edit(src, "    case 3: launch_lanes<3>(c, lo, hi, n, scale, "
                       "oh, ol, s); break;\n", "")
    runtime = WV._edit(runtime, "    case 3: launch_key<3, TOTAL>(lo, hi, n, "
                       "nparts, parts, scene, key, s); return true;\n", "")

    def points(k):
        out = WV._edit(src, "constexpr int kOpPoints = 1;",
                       f"constexpr int kOpPoints = {k};")
        return WV._edit(out, "constexpr int kKeyPoints = 1;",
                        f"constexpr int kKeyPoints = {k};")
    return {"loop": loop, "runtime": runtime, "points2": points(2),
            "points4": points(4)}


def tail_sources(src):
    import walk_variants as WV
    fenced = WV._edit(src, """  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(flag)
               : "memory");
  return old;""", """  __threadfence();
  const int old = atomicAdd(flag, 1);
  __threadfence();
  return old;""")
    # a 3-D tree without records: the generic climb (boxes from the node
    # arrays); the records are packed at the first query
    bare = WV._edit(src, "(t.dim == 3) != (t.records != nullptr)", "false")
    bare = WV._edit(bare, "  if (t.dim == 3) {\n    climb_kernel3",
                    "  if (t.records != nullptr) {\n    climb_kernel3")
    # the parent's ropes: two dependent loads in the climb after each
    # arrival (the rope pass writes only the leaves' range_last)
    ropes = WV._edit(src, """  t.rope[k] = last >= n1 ? -1 : __ldg(t.right + __ldg(t.owner + last));
""", "")
    ropes = WV._edit(ropes, """__device__ __forceinline__ int rope_at(const Tree& t, int node) {
  return __ldg(t.rope + node);
}""", """__device__ __forceinline__ int rope_at(const Tree& t, int node) {
  const int n1 = t.n - 1;
  const int last = node >= n1 ? node - n1 : __ldg(t.last + node);
  const int r = last >= n1 ? -1 : __ldg(t.right + __ldg(t.owner + last));
  t.rope[node] = r;
  return r;
}""")
    return {"fenced": fenced, "bare": bare, "climb_ropes": ropes}


def _key_entry(lib, box_lo, box_hi, bits, key, parts, stream):
    import ctypes
    from repro_torch.kernels import morton as KM
    fn = getattr(lib, "morton_key_launch")
    fn.argtypes, fn.restype = KM._KEY_ARGS, ctypes.c_int
    n, dim = box_lo.shape
    return lambda: fn(box_lo.data_ptr(), box_hi.data_ptr(), n, dim, bits,
                      parts.data_ptr(), key.data_ptr(), stream)


def _lanes_entry(lib, c, lo, hi, out_hi, out_lo, stream):
    import ctypes
    from repro_torch.core.morton import bits_per_dim
    from repro_torch.kernels import morton as KM
    fn = getattr(lib, "morton64_launch")
    fn.argtypes, fn.restype = KM._ARGS, ctypes.c_int
    n, dim = c.shape
    return lambda: fn(c.data_ptr(), lo.data_ptr(), hi.data_ptr(), n, dim,
                      bits_per_dim(dim), out_hi.data_ptr(), out_lo.data_ptr(),
                      stream)


def morton_levers(card, libs, committed):
    import torch
    import chip_smoke as smoke
    import walk_variants as WV
    from repro_torch.core import morton as M
    from repro_torch.kernels import morton as KM
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = smoke.N
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 31)
    for dim in (3, 6):
        box_lo = torch.rand((n, dim), generator=gen, device=dev)
        box_hi = box_lo + smoke.BOX_SIDE
        c = 0.5 * (box_lo + box_hi)
        lo, hi = c.amin(0), c.amax(0)
        parts = KM.key_scratch(dim, dev)
        want_key = KM.morton_key(box_lo, box_hi)
        want_lanes = KM.morton64(c, lo, hi)
        runs = []
        for name in ("committed", "loop", "runtime", "points2", "points4",
                     "parent"):
            lib = committed if name == "committed" else libs.get(name)
            if lib is None:
                continue
            oh, ol = torch.empty_like(want_lanes[0]), \
                torch.empty_like(want_lanes[1])
            lanes = _lanes_entry(lib, c, lo, hi, oh, ol, stream)
            lanes()
            torch.cuda.synchronize()
            if not (torch.equal(oh, want_lanes[0]) and
                    torch.equal(ol, want_lanes[1])):
                raise SystemExit(f"build_variants: {name}'s op differs")
            runs.append((f"op {name}", lanes))
            if name == "parent":
                continue
            key = torch.empty_like(want_key)
            run = _key_entry(lib, box_lo, box_hi, 64, key, parts, stream)
            run()
            torch.cuda.synchronize()
            if not torch.equal(key, want_key):
                raise SystemExit(f"build_variants: {name}'s key differs")
            runs.append((f"key {name}", run))

        # the two lanes on the centroids, then the torch ops that make the
        # centroids, their scene and the sort key, against the one key
        def lanes_then_key():
            cc = 0.5 * (box_lo + box_hi)
            h, l_ = KM.morton64(cc, cc.amin(0), cc.amax(0))
            return M.key_of((h, l_))
        if not torch.equal(lanes_then_key(), want_key):
            raise SystemExit("build_variants: the lanes' key differs")
        runs.append(("lanes then key (torch)", lanes_then_key))
        runs.append(("key through the wrapper",
                     lambda: KM.morton_key(box_lo, box_hi)))
        for name, ms in WV.in_turns(runs, reps=50).items():
            print(f"[variants] morton dim {dim} N={n} {name}: {ms[0]:.4f} / "
                  f"{ms[1]:.4f} ms, identical to committed  [{card}]",
                  flush=True)


def tail_levers(card, libs):
    import ctypes
    import torch
    import chip_smoke as smoke
    import repro_torch as rt
    import walk_variants as WV
    from repro_torch.core import geometry as G
    from repro_torch.core import morton as M
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = smoke.N
    pts, box_lo, box_hi, qc = smoke.make_data(dev)
    policy = rt.ExecutionPolicy()
    spheres = rt.intersects(G.Spheres(qc, torch.full((smoke.Q,), smoke.RADIUS,
                                                     device=dev)))
    for label, lo, hi in (("points", pts, pts), ("boxes", box_lo, box_hi)):
        key, perm = torch.sort(KM.morton_key(lo, hi), stable=True)
        first, last, gamma = KB.karras_ranges(*M.key_lanes(key), n,
                                              KB.max_log2(n))
        args = (first, last, gamma, perm, lo, hi)
        want = KB.lbvh_tail(*args)
        runs = [("committed", lambda: KB.lbvh_tail(*args)),
                ("rmq (the twin on the card)",
                 lambda: KB.lbvh_tail_ref(*args))]
        scratch = torch.empty((4 * n - 3,), dtype=torch.int32, device=dev)
        for name, records in (("fenced", True), ("climb_ropes", True),
                              ("bare", False)):
            fn = getattr(libs[name], "lbvh_tail_launch")
            fn.argtypes, fn.restype = KB._TAIL_ARGS, ctypes.c_int
            out = [torch.empty_like(t) for t in want[:7]]
            rec = torch.empty_like(want[7]) if records else None
            ptrs = [t.data_ptr() for t in args] + [n, 3] + \
                [t.data_ptr() for t in out] + \
                [None if rec is None else rec.data_ptr(), scratch.data_ptr(),
                 stream]
            if fn(*ptrs) != 0:
                raise SystemExit(f"build_variants: {name} failed to launch")
            torch.cuda.synchronize()
            if not all(smoke.same_bits(a, b) for a, b in zip(out, want)) or \
                    (rec is not None and not torch.equal(rec, want[7])):
                raise SystemExit(f"build_variants: {name} differs")
            if records:
                runs.append((name, lambda fn=fn, ptrs=ptrs: fn(*ptrs)))
            else:
                # no records in the tail, the pack at the first query
                def bare_then_pack(fn=fn, ptrs=ptrs, out=out):
                    fn(*ptrs)
                    T.pack_nodes(out[0], out[1], out[4], out[2], out[6])
                runs.append(("bare + records at first query", bare_then_pack))
        for name, ms in WV.in_turns(runs, reps=20).items():
            print(f"[variants] tail {label} N={n} {name}: {ms[0]:.4f} / "
                  f"{ms[1]:.4f} ms, identical to committed  [{card}]",
                  flush=True)
        # records in the build against records at the first query, end to
        # end: a build and the first query of the fresh index
        values = G.Points(pts) if label == "points" else G.Boxes(lo, hi)

        def build_and_query(drop):
            index = rt.BVH(values, policy=policy)
            if drop:
                index.tree.__dict__.pop("records")
            index.query(spheres)
        build_and_query(False)
        for name, ms in WV.in_turns(
                [("build + first query, records in the build",
                  lambda: build_and_query(False)),
                 ("build + first query, records packed at the query",
                  lambda: build_and_query(True))], reps=5).items():
            print(f"[variants] {label} N={n} {name}: {ms[0]:.3f} / "
                  f"{ms[1]:.3f} ms  [{card}]", flush=True)


def levers():
    import ctypes
    import walk_variants as WV
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    card = _card()
    print(f"[variants] {card}", flush=True)
    mo_src = open(os.path.join(_build.CSRC, "morton.cu")).read()
    ta_src = open(os.path.join(_build.CSRC, "lbvh_tail.cu")).read()
    sources = {**morton_sources(mo_src), **tail_sources(ta_src)}
    if "--parent" in sys.argv:
        pdir = os.path.join(sys.argv[sys.argv.index("--parent") + 1], "src",
                            "repro_torch", "csrc")
        sources["parent"] = open(os.path.join(pdir, "morton.cu")).read()
    _build.build_all(("morton", "karras", "lbvh_tail", "bvh_traverse"))
    libs = WV.build(sources, show=("lanes_kernel<3>", "key_kernel<3, 64>",
                                   "climb_kernel3", "climb_kernel<1>",
                                   "lanes_generic", "morton_kernel"),
                    out=OUT)
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)
    committed = ctypes.CDLL(str(_build._library_path("morton")))
    morton_levers(card, libs, committed)
    tail_levers(card, libs)


def main():
    import torch
    if not torch.cuda.is_available():
        print("build_variants: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if "levers" in sys.argv[1:]:
        levers()
    else:
        breakdown()
    print(f"[variants] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
