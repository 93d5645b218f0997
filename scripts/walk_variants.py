#!/usr/bin/env python3
"""Time design variants of the 3-D callback walk and of the 3-D
``ray_box_nearest`` kernel on one CUDA card, in turns.

    python3 scripts/walk_variants.py        # from the checkout root

Each variant is either a text edit of the committed
``src/repro_torch/csrc/bvh_callback.cu`` or ``ray_box.cu``, built with
the port's nvcc flags into ``build/walk_variants/``, or the committed
library called through its C entry point with other arguments:

  callback walk (DBSCAN's two walks at N = Q = 2^20 on ``chip_smoke.py``'s
  cloud, and sphere counting at Q = 2^17 over its 2^20 search points)
    committed         node records, the leaf order where the queries are
                      the indexed points, min_where's one gather, the
                      leaf test taken from the node test, 256 threads
    no_order          the queries in the caller's order
    morton_order      a Morton order of the query centres computed per
                      call (its step timed apart)
    generic_instance  no node records: the any-dim kernel
    two_gathers       min_where reads flags, then weights (an edit)
    no_leaf_reuse     each leaf gathers its point (an edit)
    block_128         128-thread blocks (an edit)
    parent_design     no records, no order, two gathers
  ray_box_nearest (chip_smoke.py's 2^17 rays x 2^20 boxes)
    committed, eight_rays (8 rays a thread, an edit), three_stages (a
    three-stage ring, an edit), one_split (the box axis whole),
    c_min_max (the C min / max, an edit), generic_instance (the any-dim
    kernel)

Each variant is first held bit-identical to the committed kernel, then
timed by CUDA events; the variants run in one order and then in the
reverse one, and each line gives both times (a callback launch includes
the copy of the initial state, as the wrapper's does).

Before the timings, probes of ray_box's ring run one child process each
on small shapes under a time limit, and each line says how the child
ended and how long its failing launch took: ``eight_rays_three_stages``
(both edits together; it joins the timings when it is right), then the
same with the kernel's first issues in a loop the compiler unrolls
(``_unrolled``, the form that faulted), also at six rays a thread and at
four stages, and three edits of that: ``_dbg``, whose waits give up
after 1 s and write, for the first 64 blocks, each waiting warp's tile,
parity and the raw words of the block's three mbarriers into pinned
host memory, which the child prints after the launch fails; 4 KiB more
shared memory than it uses (``_slack``); and the mbarriers before the
ring (``_bars_first``).
``python3 scripts/walk_variants.py --probe NAME`` runs one probe alone
(after a full run has built it).
Needs one card; exits nonzero without one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "walk_variants")
PROBE_SHAPES = ((1029, 4097), (5000, 70000))
PROBE_SECONDS = 90
PROBES = ("eight_rays_three_stages", "eight_rays_three_stages_unrolled",
          "six_rays_three_stages_unrolled", "eight_rays_four_stages_unrolled",
          "eight_rays_three_stages_unrolled_dbg",
          "eight_rays_three_stages_unrolled_slack",
          "eight_rays_three_stages_unrolled_bars_first")
#: the committed kernel's first issues run in a rolled loop
ROLLED = "#pragma unroll 1\n    for (int s = 0; s < S && s < full; ++s)"
#: (blocks, warps, words) of the debug variant's records
DBG_BLOCKS, DBG_WARPS, DBG_WORDS = 64, 4, 8

# the debug variant's wait: the committed mbar_wait, giving up after 1 s
# with a record of the waiting warp (blocks < 64) in g_dbg
_DBG_WAIT = r"""
__device__ unsigned long long* g_dbg;

__device__ void dbg_wait(uint32_t bar, uint32_t parity, int t, int full,
                         int count, uint32_t bar0) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = hopper::global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > 1000000000ull) {
      const unsigned blk = blockIdx.y * gridDim.x + blockIdx.x;
      if (blk < 64 && threadIdx.x % 32 == 0) {
        unsigned long long* o = g_dbg + (blk * 4 + threadIdx.x / 32) * 8;
        unsigned long long w0, w1, w2;
        asm volatile("ld.shared.b64 %0, [%1];" : "=l"(w0) : "r"(bar0));
        asm volatile("ld.shared.b64 %0, [%1];" : "=l"(w1) : "r"(bar0 + 8));
        asm volatile("ld.shared.b64 %0, [%1];" : "=l"(w2) : "r"(bar0 + 16));
        o[1] = t; o[2] = parity; o[3] = full; o[4] = count;
        o[5] = w0; o[6] = w1; o[7] = w2;
        __threadfence_system();
        o[0] = 1 + blk;
        __threadfence_system();
      }
      __trap();
    }
  }
}

"""


def _edit(src, old, new):
    if old not in src:
        raise SystemExit(f"walk_variants: the source no longer holds {old!r}")
    return src.replace(old, new)


def callback_sources(src, n, big):
    """{variant: source} of bvh_callback.cu; two_gathers reads the flags
    as n bytes after the n weights of its buffer, and `big` where unset."""
    two = _edit(src, "m = min(m, __ldg(weights + orig));",
                "m = min(m, __ldg(reinterpret_cast<const unsigned char*>("
                f"weights + {n}) + orig) ? __ldg(weights + orig) : {big});")
    return {
        "two_gathers": two,
        "no_leaf_reuse": _edit(src, "const bool reuse = vg.kind != kSpheres;",
                               "const bool reuse = false;"),
        "block_128": _edit(src, "constexpr int kThreads = 256;",
                           "constexpr int kThreads = 128;"),
    }


def _bars_first(src):
    """The mbarriers at the start of the dynamic shared memory, the ring
    64 bytes after them (64 bytes more allocated)."""
    src = _edit(src, "  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + "
                "S * 6 * kTile3);\n", "")
    src = _edit(src, "kStages * (6 * kTile3 * sizeof(float) + "
                "sizeof(uint64_t));", "kStages * (6 * kTile3 * sizeof(float) + "
                "sizeof(uint64_t)) + 64;")
    return _edit(src, "extern __shared__ __align__(16) float ring[];",
                 "extern __shared__ __align__(16) float ring_base[];\n"
                 "  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_base);\n"
                 "  float* ring = ring_base + 16;")


def ray_box_sources(src):
    eight = _edit(src, "constexpr int kRays3 = 4;", "constexpr int kRays3 = 8;")
    three = "constexpr int kStages = 3;"
    eight_three = _edit(eight, "constexpr int kStages = 2;", three)
    unrolled = _edit(eight_three, ROLLED,
                     "    for (int s = 0; s < S && s < full; ++s)")
    dbg = _edit(_edit(unrolled, "// grid (ray blocks, splits)",
                      _DBG_WAIT + "// grid (ray blocks, splits)"),
                "hopper::mbar_wait(hopper::smem_addr(bars + s), (t / S) & 1);",
                "dbg_wait(hopper::smem_addr(bars + s), (t / S) & 1, t, full, "
                "count, hopper::smem_addr(bars));")
    dbg += ("\nREPRO_EXPORT int set_dbg(void* p) {\n  return static_cast<int>("
            "cudaMemcpyToSymbol(g_dbg, &p, sizeof(p)));\n}\n")
    c_min = _edit(_edit(src, 'asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : '
                        '"f"(a), "f"(b));', "r = min_nan(a, b);"),
                  'asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
                  "r = max_nan(a, b);")
    return {
        "eight_rays": eight,
        "three_stages": _edit(src, "constexpr int kStages = 2;", three),
        "eight_rays_three_stages": eight_three,
        "eight_rays_three_stages_unrolled": unrolled,
        "six_rays_three_stages_unrolled": _edit(
            unrolled, "constexpr int kRays3 = 8;", "constexpr int kRays3 = 6;"),
        "eight_rays_four_stages_unrolled": _edit(
            unrolled, three, "constexpr int kStages = 4;"),
        "eight_rays_three_stages_unrolled_dbg": dbg,
        "eight_rays_three_stages_unrolled_slack": _edit(
            unrolled, "kStages * (6 * kTile3 * sizeof(float) + "
            "sizeof(uint64_t));", "kStages * (6 * kTile3 * sizeof(float) + "
            "sizeof(uint64_t)) + 4096;"),
        "eight_rays_three_stages_unrolled_bars_first": _bars_first(unrolled),
        "c_min_max": c_min,
    }


def build(sources, show=("callback_kernel3<256, MinWhere", "ray_box3_kernel"),
          out=OUT):
    """{name: ctypes library}, every nvcc started at once into `out`;
    prints the registers and spills of the kernels whose names start with
    one of `show`."""
    from repro_torch.kernels import _build
    import chip_smoke as smoke
    os.makedirs(out, exist_ok=True)
    for header in os.listdir(_build.CSRC):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, header), out)
    jobs = {}
    for name, text in sources.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out, f"{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"walk_variants: {name} failed to build\n{text}")
        libs[name] = ctypes.CDLL(so)
        for fn, regs, spill in smoke._ptxas_summary(text):
            if fn.startswith(show):
                print(f"[variants] {name} {fn}: {regs} registers, {spill} B "
                      "spill stores", flush=True)
    return libs


def entry(lib, fn, argtypes):
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def in_turns(runs, reps):
    """{name: [ms, ms]}: each run timed in one order, then in the reverse
    one."""
    import chip_smoke as smoke
    times = {name: [] for name, _ in runs}
    for seq in (runs, runs[::-1]):
        for name, run in seq:
            times[name].append(smoke.time_ms(run, reps=reps))
    return times


def ray_plan(r, b, sms, rays):
    """kernels.ray_box.plan for `rays` rays per thread."""
    from repro_torch.kernels import ray_box as KR
    ray_blocks = -(-r // (KR.THREADS * rays))
    tiles = max(1, -(-b // KR.TILE))
    want = min(tiles, max(1, -(-KR.BLOCKS_PER_SM * sms // ray_blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per * KR.TILE


def ray_runner(fn, o, d, lo, hi, splits, chunk, keys=True):
    """A closure that runs one ray_box launch through `fn` and returns
    (t, idx)."""
    import torch
    from repro_torch.kernels import ray_box as KR
    from repro_torch.kernels.bvh_traverse import _stream
    r, b = o.shape[0], lo.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=o.device)
    i = torch.empty((r,), dtype=torch.int32, device=o.device)
    k = (torch.empty((r,), dtype=torch.int64, device=o.device) if keys
         else None)

    def run():
        if k is None:
            t.fill_(float("inf"))
            i.fill_(-1)
        else:
            k.fill_(KR.NO_HIT)
        err = fn(o.data_ptr(), d.data_ptr(), lo.data_ptr(), hi.data_ptr(), r,
                 b, 3, t.data_ptr(), i.data_ptr(),
                 None if k is None else k.data_ptr(), splits, chunk,
                 _stream(o.device))
        if err:
            raise SystemExit(f"walk_variants: ray_box launch refused ({err})")
        return t, i

    return run


def probe(name):
    """Child process: the variant `name` against the twin on the small
    shapes, one line each; a failing launch prints its time and, for the
    debug variant, the records of the waiting warps."""
    import numpy as np
    import torch
    from repro_torch.kernels import ray_box as KR
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    fn = entry(lib, "ray_box_nearest_launch", KR._ARGS)
    rays = {"eight": 8, "six": 6}[name.split("_")[0]]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dbg = None
    if name.endswith("_dbg"):
        dbg = torch.zeros((DBG_BLOCKS * DBG_WARPS, DBG_WORDS),
                          dtype=torch.int64, pin_memory=True)
        if entry(lib, "set_dbg", [ctypes.c_void_p])(dbg.data_ptr()):
            raise SystemExit("walk_variants: set_dbg failed")
    g = torch.Generator().manual_seed(1)
    for r, b in PROBE_SHAPES:
        lo = torch.rand((b, 3), generator=g)
        hi = lo + 0.05 * torch.rand((b, 3), generator=g)
        o = torch.rand((r, 3), generator=g)
        d = torch.randn((r, 3), generator=g)
        args = [x.to(dev) for x in (o, d, lo, hi)]
        splits, chunk = ray_plan(r, b, sms, rays)
        head = f"R={r} B={b} splits {splits} chunk {chunk}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            t, i = ray_runner(fn, *args, splits, chunk)()
            torch.cuda.synchronize()
        except Exception as e:  # the failing launch is the finding
            print(f"{head}: the launch failed after "
                  f"{time.perf_counter() - t0:.2f} s: "
                  f"{str(e).splitlines()[0]}", flush=True)
            if dbg is not None:
                rec = dbg.numpy().astype(np.uint64)
                for at in np.nonzero(rec[:, 0])[0][:12]:
                    row = rec[at]
                    blk, warp = divmod(int(at), DBG_WARPS)
                    print(f"  block {blk} warp {warp}: tile {int(row[1])} "
                          f"parity {int(row[2])} full {int(row[3])} count "
                          f"{int(row[4])} mbarriers " + " ".join(
                              f"{int(w):#018x}" for w in row[5:]), flush=True)
                print(f"  {int((rec[:, 0] != 0).sum())} warps of the first "
                      f"{DBG_BLOCKS} blocks gave up", flush=True)
            return 1
        wt, wi = KR.ray_box_nearest_ref(*args)
        ok = torch.equal(t, wt) and torch.equal(i, wi)
        print(f"{head}: {time.perf_counter() - t0:.2f} s, "
              f"{'identical' if ok else 'DIFFERS'}", flush=True)
        if not ok:
            return 1
    return 0


def callback_phase(card, libs, main_cb):
    import torch
    import repro_torch as rt
    import chip_smoke as smoke
    from repro_torch.core import geometry as G
    from repro_torch.core import morton as M
    from repro_torch.core.dbscan import _BIG
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import morton as KM
    from repro_torch.kernels.bvh_traverse import _stream

    dev = torch.device("cuda", 0)
    policy = rt.ExecutionPolicy(device=dev)

    def lib(name):
        return entry(libs[name], "bvh_callback_launch", KC._ARGS)

    def walks(label, index, centres, radii, epilogue, param, s0, flags=None,
              weights=None):
        t = index.tree
        n, q = len(index.values), centres.shape[0]
        coords = index.values.coords
        tree = [t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
                t.leaf_perm]
        mp = torch.full((q,), -1, dtype=torch.int32, device=dev)
        out = s0.clone()
        leaf = (t.leaf_perm if centres.data_ptr() == coords.data_ptr()
                else None)

        def morton():
            codes = KM.morton64(centres, t.node_lo[0].contiguous(),
                                t.node_hi[0].contiguous())
            aux = torch.arange(q, dtype=torch.int32, device=dev)
            return M.sort_by_morton(codes, aux)[1]

        order_ms = smoke.time_ms(morton, reps=5)
        computed = morton()
        one = two = None
        if flags is not None:
            one = torch.where(flags, weights, _BIG).to(torch.int32)
            two = torch.cat([weights.view(torch.uint8),
                             flags.view(torch.uint8)])
        variants = [("committed", main_cb, t.records, leaf, one),
                    ("no_order", main_cb, t.records, None, one),
                    ("morton_order", main_cb, t.records, computed, one),
                    ("generic_instance", main_cb, None, leaf, one),
                    ("two_gathers", lib("two_gathers"), t.records, leaf, two),
                    ("no_leaf_reuse", lib("no_leaf_reuse"), t.records, leaf,
                     one),
                    ("block_128", lib("block_128"), t.records, leaf, one),
                    ("parent_design", lib("two_gathers"), None, None, two)]
        runs, ref = [], None
        for name, fn, records, order, w in variants:
            def run(fn=fn, records=records, order=order, w=w):
                out.copy_(s0)
                err = fn(*(a.data_ptr() for a in tree),
                         None if records is None else records.data_ptr(),
                         None, None if order is None else order.data_ptr(),
                         centres.data_ptr(), None, radii.data_ptr(),
                         coords.data_ptr(), None, None, None, mp.data_ptr(),
                         n, q, 3, 2, 0, epilogue, param, 0, KC.BLOCK_Q,
                         out.data_ptr(),
                         None, None, None if w is None else w.data_ptr(),
                         _stream(dev))
                if err:
                    raise SystemExit(f"walk_variants: {label} {name}: launch "
                                     f"refused ({err})")

            run()
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            if not torch.equal(out, ref):
                raise SystemExit(f"walk_variants: {label} {name} differs "
                                 "from committed")
            runs.append((name, run))
        for name, ms in in_turns(runs, reps=5).items():
            print(f"[variants] {label} {name}: {ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"identical to committed  [{card}]", flush=True)
        print(f"[variants] {label}: the Morton order step {order_ms:.4f} ms",
              flush=True)
        return ref

    coords = smoke.make_cloud(dev)
    n = coords.shape[0]
    index = rt.BVH(G.Points(coords), policy=policy)
    radii = torch.full((n,), smoke.DB_EPS, device=dev)
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    counts = walks(f"dbscan count_with_limit N=Q={n}", index, coords, radii,
                   1, smoke.DB_MIN_PTS, zeros)
    is_core = counts >= smoke.DB_MIN_PTS
    labels0 = torch.where(is_core, torch.arange(n, dtype=torch.int32,
                                                device=dev), _BIG)
    walks(f"dbscan min_where N=Q={n}", index, coords, radii, 5, 0,
          torch.full((n,), _BIG, dtype=torch.int32, device=dev), is_core,
          labels0)
    del index, coords
    pts, _, _, qc = smoke.make_data(dev)
    index = rt.BVH(G.Points(pts), policy=policy)
    walks(f"spatial counting N={smoke.N} Q={smoke.Q}", index, qc,
          torch.full((smoke.Q,), smoke.RADIUS, device=dev), 0, 0,
          torch.zeros((smoke.Q,), dtype=torch.int32, device=dev))


def ray_box_phase(card, libs, main_rb, probe_ok):
    import torch
    import chip_smoke as smoke
    from repro_torch.core import geometry as G
    from repro_torch.kernels import ray_box as KR

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    a, b, c, o, d = smoke.make_soup(dev)
    boxes = G.to_boxes(G.Triangles(a, b, c))
    lo, hi = boxes.lo.contiguous(), boxes.hi.contiguous()
    r, nb = o.shape[0], lo.shape[0]
    plan4, plan8 = ray_plan(r, nb, sms, 4), ray_plan(r, nb, sms, 8)
    whole = (1, -(-nb // KR.TILE) * KR.TILE)
    def lib(name):
        return entry(libs[name], "ray_box_nearest_launch", KR._ARGS)

    variants = [("committed", main_rb, plan4, True),
                ("eight_rays", lib("eight_rays"), plan8, True),
                ("three_stages", lib("three_stages"), plan4, True),
                ("one_split", main_rb, whole, True),
                ("c_min_max", lib("c_min_max"), plan4, True),
                ("generic_instance", main_rb, (1, KR.TILE), False)]
    if probe_ok:
        variants.append(("eight_rays_three_stages",
                         lib("eight_rays_three_stages"), plan8, True))
    runs, ref = [], None
    for name, fn, (splits, chunk), keys in variants:
        run = ray_runner(fn, o, d, lo, hi, splits, chunk, keys)
        t, i = run()
        torch.cuda.synchronize()
        if ref is None:
            ref = (t.clone(), i.clone())
        if not (torch.equal(t, ref[0]) and torch.equal(i, ref[1])):
            raise SystemExit(f"walk_variants: ray_box {name} differs from "
                             "committed")
        runs.append((f"{name} ({splits} splits of {chunk})", run))
    for name, ms in in_turns(runs, reps=3).items():
        print(f"[variants] ray_box R={r} B={nb} {name}: {ms[0]:.3f} / "
              f"{ms[1]:.3f} ms, identical to committed  [{card}]", flush=True)


def main():
    if sys.argv[1:2] == ["--probe"]:
        return probe(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("walk_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.core.dbscan import _BIG
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import ray_box as KR
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[variants] {card}", flush=True)
    cb_src = open(os.path.join(_build.CSRC, "bvh_callback.cu")).read()
    rb_src = open(os.path.join(_build.CSRC, "ray_box.cu")).read()
    sources = {**callback_sources(cb_src, smoke.DB_BLOBS * smoke.DB_BLOB_PTS
                                  + smoke.DB_NOISE, _BIG),
               **ray_box_sources(rb_src)}
    _build.build_all(("bvh_callback", "ray_box"))
    libs = build(sources)
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)

    probe_ok = {}
    for name in PROBES:
        start = time.perf_counter()
        try:
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--probe", name],
                capture_output=True, text=True, timeout=PROBE_SECONDS)
            ended = f"exit {child.returncode}"
            text = child.stdout.strip()
        except subprocess.TimeoutExpired as e:
            ended = f"killed at the {PROBE_SECONDS} s limit"
            text = (e.stdout or b"").decode().strip()
        probe_ok[name] = ended == "exit 0"
        print(f"[variants] probe {name}: {ended} after "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        for line in text.splitlines():
            print(f"[variants]   {line}", flush=True)

    main_cb = _build.function("bvh_callback", "bvh_callback_launch", KC._ARGS)
    callback_phase(card, libs, main_cb)
    main_rb = _build.function("ray_box", "ray_box_nearest_launch", KR._ARGS)
    ray_box_phase(card, libs, main_rb,
                  probe_ok["eight_rays_three_stages"])
    print(f"[variants] done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
