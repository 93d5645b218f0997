#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the checkout root; needs one card

Phases (one line or more each, then the two closing lines):

  1. device: the card's name and count, and nvidia-smi's name and power
     limit; fails without a CUDA device.
  2. build: compiles every CUDA kernel of ``src/repro_torch/csrc`` (one
     nvcc per source, all at once) and prints the seconds.
  3. kernels: each kernel's wrapper against its plain PyTorch twin on the
     card, at the main path's widths (N = 2^20 uniform points in the unit
     cube, ArborX bvh_driver's "filled box"; Q = 2^17 queries):
     karras_ranges integer-identical; bvh_traverse_spatial identical counts
     and buffers for Points values (fine_sqrt) and Boxes values;
     bvh_traverse_knn (k = 10) identical indices and distances.
  4. main path: ``BVH(Points)`` and ``BVH(Boxes)`` at N = 2^20 on the card,
     each answering ``query(intersects(Spheres(c, r)))`` (r = 0.0132, about
     10 neighbours, bvh_driver's convention) and ``query(nearest(Points,
     k=10))`` for Q = 2^17; checked on 2048 queries against BruteForce
     (CSR offsets and index sets equal) and against an exact float64
     oracle (kNN distances within 1e-6 relative). The launch counters are
     zeroed before this phase and read after it: one karras_ranges launch
     per build, two spatial launches per CSR query, one kNN launch per
     kNN query.
  5. timings: CUDA events around repeated launches after a warm-up, for
     each kernel and its twin, and end-to-end build / query times.
  6. profile: one build + CSR query + kNN query of the Points index under
     torch.profiler: device-busy share of the window and the kernels that
     take the device time ("not measured" when the profiler sees no
     device activity).

The line before the last is ``{"kernels": [...]}`` (name, route, source,
replaced TPU kernel, launches, max_abs_err, ms, plain_ms, bound_ms,
bound_by, library_ms); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and the script exits nonzero without them.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 1 << 20
Q = 1 << 17
K = 10
RADIUS = 0.0132
BOX_SIDE = 0.01
N_CHECK = 2048
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and float32
# operations/s outside the tensor cores, which also serves as the rate
# for the integer work (the card's int32 rate is not higher, so the
# bound stays a floor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call, by CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_bytes(n, dim, range_last):
    """Bytes of the tree arrays a walk takes, each read once: node boxes
    and ropes (and range_last) over 2N-1 nodes, left children, leaf_perm."""
    per_node = 2 * dim * 4 + 4 + (4 if range_last else 0)
    return (2 * n - 1) * per_node + (n - 1) * 4 + n * 4


# operations of one leaf test: dim differences, clamps and squares, and
# the sum, plus the compare (and, for kNN, the insert's compare)
def leaf_ops(dim):
    return 6 * dim + 2


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(card)
    return name, count, card


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in {secs:.1f} s "
        f"({', '.join(_build.SOURCES)})")
    for src in _build.SOURCES:
        for fn, regs, spill in _ptxas_summary(_build.build_log(src)):
            log(f"[build] {src} {fn}: {regs} registers, {spill} B spill stores")


def _ptxas_summary(text):
    """(kernel, registers, spill-store bytes) per entry of `-Xptxas -v`."""
    out, fn, spill = [], None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(karras_kernel|spatial_kernelILb[01]E|knn_kernelILi\d+E)",
                          m.group(1))
            fn = k.group(1) if k else m.group(1)
            fn = re.sub(r"ILb([01])E", r"<\1>", re.sub(r"ILi(\d+)E", r"<\1>", fn))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
    return out


def make_data(dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((N, 3), generator=gen, device=dev)
    box_lo = torch.rand((N, 3), generator=gen, device=dev)
    qc = torch.rand((Q, 3), generator=gen, device=dev)
    return pts, box_lo, box_lo + BOX_SIDE, qc


def phase_kernels(dev, pts, box_lo, box_hi, qc):
    """Each kernel against its twin at the main path's shapes. Returns the
    per-kernel records (without launches) for the kernels line."""
    import torch
    from repro_torch.core import geometry as G
    from repro_torch.core import lbvh as L
    from repro_torch.core import morton as M
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB

    rec = {}

    # -- karras_ranges on the sorted Morton keys of the points ----------
    codes = M.morton64(pts, pts.amin(0), pts.amax(0))
    perm0 = torch.arange(N, device=dev)
    codes_s, _ = M.sort_by_morton(codes, perm0)
    hi, lo, idx = M.combined_delta_key(codes_s, N)
    ml2 = max((N - 1).bit_length(), 1)
    got = KB.karras_ranges(hi, lo, idx, N, ml2)
    want = KB.karras_ranges_fused(hi, lo, idx, N, ml2)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    check(err == 0, f"karras_ranges differs from its twin (max {err})")
    ms = time_ms(lambda: KB.karras_ranges(hi, lo, idx, N, ml2), reps=50)
    plain = time_ms(lambda: KB.karras_ranges_fused(hi, lo, idx, N, ml2), reps=3)
    probes = 2 * (ml2 + 1) + 3
    b_ms, b_by = bound(3 * N * 4 + 3 * (N - 1) * 4, (N - 1) * probes * 12)
    rec["karras_ranges"] = dict(
        source="src/repro_torch/csrc/karras.cu",
        replaces="src/repro/kernels/lbvh_build.py:196",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    log(f"[kernels] karras_ranges N={N}: identical to twin (tolerance 0); "
        f"{ms:.4f} ms vs twin {plain:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    del codes, codes_s, hi, lo, idx, got, want

    # -- bvh_traverse_spatial: Points values (fine_sqrt) and Boxes values --
    r = torch.full((Q,), RADIUS, device=dev)
    spatial = []
    for label, boxes, fine in (("points", G.Boxes(pts, pts), True),
                               ("boxes", G.Boxes(box_lo, box_hi), False)):
        t = L.build(boxes)
        args = (t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
                t.leaf_perm, qc, qc, r)
        cnt, _ = T.bvh_traverse_spatial(*args, capacity=1, fine_sqrt=fine)
        cap = max(int(cnt.max()), 1)
        stats = {}
        got = T.bvh_traverse_spatial(*args, capacity=cap, fine_sqrt=fine)
        want = T.bvh_traverse_spatial_ref(*args, capacity=cap, fine_sqrt=fine,
                                          stats=stats)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        check(err == 0 and torch.equal(got[1], want[1]),
              f"bvh_traverse_spatial ({label}) differs from its twin")
        ms = time_ms(lambda: T.bvh_traverse_spatial(*args, capacity=cap,
                                                    fine_sqrt=fine), reps=20)
        plain = time_ms(lambda: T.bvh_traverse_spatial_ref(
            *args, capacity=cap, fine_sqrt=fine), reps=1, warmup=0)
        # the bound does not depend on the walk: queries (lo, hi, r) and
        # the tree read once, counts and buffer written once, and one leaf
        # test per match, the least any exact range search does
        nbytes = Q * (2 * 3 * 4 + 4) + tree_bytes(N, 3, True) + Q * 4 * (1 + cap)
        b_ms, b_by = bound(nbytes, int(got[0].sum()) * leaf_ops(3))
        spatial.append(dict(label=label, cap=cap, visits=stats["visits"],
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by))
        log(f"[kernels] bvh_traverse_spatial {label} N={N} Q={Q} cap={cap}: "
            f"identical to twin (tolerance 0); {ms:.3f} ms vs twin "
            f"{plain:.1f} ms; {stats['visits']} node visits; bound "
            f"{b_ms:.4f} ms ({b_by})")
        if label == "points":
            tree_points = t
        del t, args, got, want
    p = spatial[0]
    rec["bvh_traverse_spatial"] = dict(
        source="src/repro_torch/csrc/bvh_traverse.cu",
        replaces="src/repro/kernels/bvh_traverse.py:177",
        max_abs_err=max(s["max_abs_err"] for s in spatial), ms=p["ms"],
        plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"])

    # -- bvh_traverse_knn, k = 10, over the points -------------------------
    t = tree_points
    args = (t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm, qc)
    stats = {}
    gd, gi = T.bvh_traverse_knn(*args, k=K)
    wd, wi = T.bvh_traverse_knn_ref(*args, k=K, stats=stats)
    torch.cuda.synchronize()
    err = float((gd - wd).abs().max())
    same_i = gi == wi
    # ties excepted: a differing index must sit at a distance equal to
    # its neighbour's in the list
    tie = torch.zeros_like(same_i)
    tie[:, 1:] |= wd[:, 1:] == wd[:, :-1]
    tie[:, :-1] |= wd[:, :-1] == wd[:, 1:]
    check(err == 0.0 and bool((same_i | tie).all()),
          f"bvh_traverse_knn differs from its twin (max |d| {err}, "
          f"{int((~same_i).sum())} indices)")
    ms = time_ms(lambda: T.bvh_traverse_knn(*args, k=K), reps=10)
    plain = time_ms(lambda: T.bvh_traverse_knn_ref(*args, k=K), reps=1,
                    warmup=0)
    # the bound does not depend on the walk either: queries and the tree
    # read once, (dists, idxs) written once, and one leaf test for each
    # leaf within the query's k-th distance (at least k; more on ties),
    # the least any exact k-NN computes. That count comes from the spatial
    # kernel, held against its twin above, at r = the k-th distance.
    within, _ = T.bvh_traverse_spatial(
        t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last, t.leaf_perm,
        qc, qc, gd[:, K - 1].contiguous(), capacity=1, fine_sqrt=True)
    leaves = int(within.clamp_min(K).sum())
    nbytes = Q * 3 * 4 + tree_bytes(N, 3, False) + Q * K * 8
    b_ms, b_by = bound(nbytes, leaves * leaf_ops(3))
    rec["bvh_traverse_knn"] = dict(
        source="src/repro_torch/csrc/bvh_traverse.cu",
        replaces="src/repro/kernels/bvh_traverse.py:301",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    log(f"[kernels] bvh_traverse_knn N={N} Q={Q} k={K}: identical to twin "
        f"(tolerance 0; {int((~same_i).sum())} tied indices swapped); "
        f"{ms:.3f} ms vs twin {plain:.1f} ms; {stats['visits']} node visits; "
        f"{leaves} leaves within the k-th distance; bound {b_ms:.4f} ms "
        f"({b_by})")
    return rec, spatial


def _oracle_knn(values_lo, values_hi, queries, k, block=128):
    """Exact k nearest in float64 (point-to-box distance; points are boxes
    with lo == hi): (dists (Qc, k), idx (Qc, k)). Independent of the port."""
    import torch
    lo, hi = values_lo.double(), values_hi.double()
    ds, ix = [], []
    for s in range(0, queries.shape[0], block):
        qb = queries[s:s + block].double()[:, None, :]
        g = torch.clamp_min(torch.maximum(lo - qb, qb - hi), 0.0)
        d, i = torch.topk((g * g).sum(-1).sqrt(), k, dim=1, largest=False)
        ds.append(d)
        ix.append(i)
    return torch.cat(ds), torch.cat(ix)


def check_csr(res, ref, nq, label):
    import torch
    off = res.offsets[:nq + 1].to(torch.int64)
    check(torch.equal(off - off[0], ref.offsets.to(torch.int64)),
          f"{label}: CSR offsets differ from BruteForce")
    a = res.indices[:int(off[-1])].to(torch.int64)
    b = ref.indices.to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(nq, device=a.device),
                                   (off[1:] - off[:-1]))
    # per-query sets: sort (row, index) pairs on both sides
    ka = torch.sort(rows * (1 << 32) + a).values
    kb = torch.sort(rows * (1 << 32) + b).values
    check(torch.equal(ka, kb), f"{label}: per-query index sets differ")


def check_knn(res, ref, oracle, label):
    """BVH kNN vs the port's BruteForce and the float64 oracle."""
    import torch
    d, i = res.distances[:N_CHECK], res.indices[:N_CHECK]
    od, _ = oracle
    check(bool((i >= 0).all()), f"{label}: kNN has padding at N={N}")
    check(bool((d[:, 1:] >= d[:, :-1]).all()), f"{label}: kNN not ascending")
    rel = float(((d.double() - od) / od.clamp_min(1e-30)).abs().max())
    check(rel <= 1e-6, f"{label}: kNN distances off the float64 oracle by "
          f"{rel:.3g} relative (tolerance 1e-6)")
    # indices: equal to BruteForce's except among equal distances
    same = i == ref.indices
    tie = torch.zeros_like(same)
    tie[:, 1:] |= d[:, 1:] == d[:, :-1]
    tie[:, :-1] |= d[:, :-1] == d[:, 1:]
    # BruteForce over Points uses the reference's |x|^2 - 2x.y + |y|^2
    # expansion: its distances carry that rounding, about
    # 4 * 2^-23 * (|q|^2 + |p|^2) in the square (coordinates in [0, 1]^3)
    d2_tol = 4 * 2.0 ** -23 * 6
    bf_err = float((d.double() ** 2 - ref.distances.double() ** 2).abs().max())
    near = (d.double() ** 2 - ref.distances.double() ** 2).abs() <= d2_tol
    check(bool((same | tie | near).all()) and bf_err <= d2_tol,
          f"{label}: kNN differs from BruteForce beyond ties "
          f"(max |d2 diff| {bf_err:.3g})")
    return rel, bf_err, int((~same).sum())


def phase_main_path(dev, pts, box_lo, box_hi, qc):
    """The port's entry points end to end, with launch counts."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB

    counters = {"karras_ranges": KB.karras_ranges,
                "bvh_traverse_spatial": T.bvh_traverse_spatial,
                "bvh_traverse_knn": T.bvh_traverse_knn}

    def counts():
        return {k: f.launches for k, f in counters.items()}

    spheres = rt.intersects(G.Spheres(qc, torch.full((Q,), RADIUS, device=dev)))
    knn = rt.nearest(G.Points(qc), k=K)
    sub_spheres = rt.intersects(G.Spheres(qc[:N_CHECK],
                                          torch.full((N_CHECK,), RADIUS,
                                                     device=dev)))
    sub_knn = rt.nearest(G.Points(qc[:N_CHECK]), k=K)
    policy = rt.ExecutionPolicy()          # device=None: the card
    results = {}

    for f in counters.values():
        f.launches = 0
    for label, values in (("points", G.Points(pts)),
                          ("boxes", G.Boxes(box_lo, box_hi))):
        c0 = counts()
        index = rt.BVH(values, policy=policy)
        check(index.device.type == "cuda", "BVH did not land on the card")
        c1 = counts()
        csr = index.query(spheres)
        c2 = counts()
        nn = index.query(knn)
        torch.cuda.synchronize()
        c3 = counts()
        check(c1["karras_ranges"] - c0["karras_ranges"] == 1,
              f"{label}: build did not launch karras_ranges once")
        check(c2["bvh_traverse_spatial"] - c1["bvh_traverse_spatial"] == 2,
              f"{label}: CSR query did not launch the spatial kernel twice")
        check(c3["bvh_traverse_knn"] - c2["bvh_traverse_knn"] == 1,
              f"{label}: kNN query did not launch the kNN kernel once")
        results[label] = (index, values, csr, nn)
    launches = counts()
    torch.cuda.synchronize()

    summary = {}
    for label, (index, values, csr, nn) in results.items():
        check(csr.offsets.shape == (Q + 1,) and not csr.overflow,
              f"{label}: bad CSR shape")
        check(bool((csr.indices >= 0).all() & (csr.indices < N).all()),
              f"{label}: CSR indices out of range")
        check(nn.distances.shape == (Q, K) and bool(torch.isfinite(nn.distances).all()),
              f"{label}: kNN shape or values")
        bf = rt.BruteForce(values, policy=policy)
        check_csr(csr, bf.query(sub_spheres), N_CHECK, label)
        if isinstance(values, G.Points):
            oracle = _oracle_knn(values.coords, values.coords, qc[:N_CHECK], K)
        else:
            oracle = _oracle_knn(values.lo, values.hi, qc[:N_CHECK], K)
        rel, bf_err, swapped = check_knn(nn, bf.query(sub_knn), oracle, label)
        total = int(csr.offsets[-1])
        log(f"[main] {label}: BVH N={N}; CSR Q={Q} {total} matches "
            f"(mean {total / Q:.2f}), {N_CHECK} queries equal to BruteForce; "
            f"kNN k={K}: max rel err vs float64 oracle {rel:.3g} (tol 1e-6), "
            f"max |d2| vs BruteForce {bf_err:.3g}, {swapped} tie swaps")
        summary[label] = index
    log(f"[main] launches in the main path: {json.dumps(launches)}")
    return launches, summary, spheres, knn, policy


def phase_timings(dev, pts, box_lo, box_hi, spheres, knn, policy, card):
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G

    out = {}
    for label, values in (("points", G.Points(pts)),
                          ("boxes", G.Boxes(box_lo, box_hi))):
        holder = {}

        def build():
            holder["index"] = rt.BVH(values, policy=policy)

        build_ms = time_ms(build, reps=3)
        index = holder["index"]
        q_ms = time_ms(lambda: index.query(spheres), reps=5)
        k_ms = time_ms(lambda: index.query(knn), reps=5)
        out[label] = dict(build_ms=build_ms, spatial_query_ms=q_ms,
                          knn_query_ms=k_ms)
        log(f"[time] {label}: build N={N} {build_ms:.2f} ms; "
            f"query(intersects(Spheres)) Q={Q} {q_ms:.2f} ms; "
            f"query(nearest k={K}) Q={Q} {k_ms:.2f} ms  [{card}]")
    torch.cuda.reset_peak_memory_stats()
    rt.BVH(G.Points(pts), policy=policy)
    torch.cuda.synchronize()
    log(f"[time] peak device memory of a Points build N={N}: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return out


def phase_profile(pts, spheres, knn, policy, card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch as rt
    from repro_torch.core import geometry as G

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index = rt.BVH(G.Points(pts), policy=policy)
        index.query(spheres)
        index.query(knn)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device-side events only (the kernels themselves): the CPU ops that
    # launched them carry the same device time and would count it twice
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("[profile] device time not measured: the profiler saw no "
            "device activity")
        return
    log(f"[profile] build + CSR query + kNN query (Points, N={N}, Q={Q}): "
        f"window {wall_us / 1e3:.2f} ms under the profiler, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f} %)  [{card}]")
    for us, key, count in rows[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")


def main():
    name, count, card = phase_device()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    pts, box_lo, box_hi, qc = make_data(dev)
    records, _ = phase_kernels(dev, pts, box_lo, box_hi, qc)
    launches, _, spheres, knn, policy = phase_main_path(dev, pts, box_lo,
                                                        box_hi, qc)
    phase_timings(dev, pts, box_lo, box_hi, spheres, knn, policy, card)
    phase_profile(pts, spheres, knn, policy, card)
    kernels = []
    for kname in ("karras_ranges", "bvh_traverse_spatial", "bvh_traverse_knn"):
        r = records[kname]
        check(launches[kname] > 0, f"{kname} was not launched in the main path")
        kernels.append({"name": kname, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"],
                        "launches": launches[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
        check(all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")),
              f"{kname}: a time is not finite")
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device phase")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
