"""Route-table tuner: the counterpart of the reference's
``benchmarks/autotune.py`` for the port.

It times the build engines, the three routes of each op (brute force,
the traversal kernels, the loop walk) and the walks' block sizes on this
machine's card with CUDA events, derives the rules from those times, and
writes a fingerprinted :class:`~repro_torch.core.route_table.RouteTable`
with its measurements (``ROUTE_TABLE_TORCH.json`` at the checkout's root
by default, which the engine reads as its ambient table).

    python -m repro_torch.launch.autotune            # tune and write
    python -m repro_torch.launch.autotune --quick    # the smaller grid
    python -m repro_torch.launch.autotune --validate [PATH]   # check

Without a card it raises, unless ``--device cpu`` asks for the CPU (its
times are the CPU twins'). ``--validate`` checks a persisted table's
schema: exit 1 on a corrupt table, 0 on a valid one or none (the defaults
apply), and 0 with a note on a table of another machine, which the
engine ignores.

The rules are a pure function of the measurements (:func:`derive_rules`):
  * bf_max_work: the power of two at the geometric mean of the largest
    N * Q where brute force beat the tree routes and the smallest where
    it lost (0 where it never won; uncapped where it never lost);
  * pallas_min_queries / pallas_min_leaves: the smallest measured Q (N)
    from which on the kernel stays within ``PARITY`` of the loop walk; 0
    where it does so at the smallest measured one;
  * pallas_max_nodes: a cap only where a measured row shows the kernel
    losing at an N above every N where it won (the power of two at
    2 N - 1 of the largest win); else uncapped. A cap is never derived
    from the largest N measured alone, which would send every larger
    tree to the loop;
  * block_q: the fastest of ``BLOCKS``;
  * build_engine: the faster build.
A table only changes which route serves a batch, never its result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import warnings

import numpy as np
import torch

from ..core import callbacks as CB
from ..core import geometry as G
from ..core import lbvh
from ..core import predicates as P
from ..core import route_table as RT
from ..core import traversal as T
from ..core.bvh import BVH
from ..core.engine import EngineConfig, QueryEngine
from ..core.index import ExecutionPolicy, _bcast_state

__all__ = ["tune", "measure", "derive_rules", "validate", "main", "BLOCKS",
           "PARITY"]

PARITY = 1.10          # the kernel within 10 % of the loop: keep the kernel
BLOCKS = (128, 256, 512)
RADIUS = 0.1
CAPACITY = 8
KNN_K = 8
SEED = 0


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 1)))), 0)


class _Timer:
    """Mean microseconds of a call: CUDA events around `reps` calls after
    one warm-up on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, fn, reps: int = 3) -> float:
        fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(self.device)
            return start.elapsed_time(end) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e6 / reps


def _cloud(n: int, seed: int, device) -> torch.Tensor:
    pts = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    return torch.from_numpy(pts.astype(np.float32)).to(device)


def _index(n: int, device) -> BVH:
    """A BVH over n uniform points on `device` (each timing names its
    route and block size itself)."""
    return BVH(G.Points(_cloud(n, SEED + 1, device)),
               policy=ExecutionPolicy(device=device))


def _spheres(q: int, device, seed: int = SEED + 2):
    c = _cloud(q, seed, device)
    return P.intersects(G.Spheres(c, torch.full((q,), RADIUS,
                                                device=device)))


def _policy(index: BVH, block_q: int) -> ExecutionPolicy:
    return index.policy.override(
        route_table=RT.RouteTable.single(block_q=block_q))


def _spatial_times(timer, index, preds, engine, *, bf=True, loop=True,
                   blocks=(256,), reps=3):
    """{route: us} of a fill of `preds` (capacity CAPACITY): brute force,
    the loop walk, the kernel at each block size ("kernel_<bq>")."""
    out = {}
    if bf:
        out["bf_us"] = timer(lambda: index._brute()._fill_impl(
            preds, CAPACITY, index.policy), reps)
    if loop:
        cb, s0 = CB.collect_hits(CAPACITY)
        s0 = _bcast_state(s0, len(preds), index.device)
        out["loop_us"] = timer(lambda: T.traverse(
            index.tree, index.values, preds, cb, s0), 1)
    for bq in blocks:
        pol = _policy(index, bq)
        out[f"kernel_{bq}_us"] = timer(lambda: engine.kernel_fill(
            index, preds, CAPACITY, policy=pol), reps)
    return out


def _knn_times(timer, index, preds, engine, *, loop=True, blocks=(256,),
               reps=3):
    out = {}
    if loop:
        out["loop_us"] = timer(lambda: T.traverse_knn(
            index.tree, index.values, preds, preds.k), 1)
    for bq in blocks:
        pol = _policy(index, bq)
        out[f"kernel_{bq}_us"] = timer(lambda: engine.kernel_knn(
            index, preds, policy=pol), reps)
    return out


def _callback_times(timer, index, preds, engine, *, loop=True,
                    blocks=(256,), reps=3):
    cb, s0 = CB.counting()
    s0 = _bcast_state(s0, len(preds), index.device)
    out = {}
    if loop:
        out["loop_us"] = timer(lambda: T.traverse(
            index.tree, index.values, preds, cb, s0), 1)
    for bq in blocks:
        pol = _policy(index, bq)
        out[f"kernel_{bq}_us"] = timer(lambda: engine.kernel_callback(
            index, preds, cb, s0, policy=pol), reps)
    return out


def measure(quick: bool = False, device=None, log=None) -> dict:
    """The tuner's measurements (microseconds) on `device` (the card by
    default; it raises without one). `log(str)` sees each row."""
    device = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the tuner measures on the card, and this "
                           "process sees none; pass --device cpu for the "
                           "CPU twins' times")
    log = log or (lambda m: None)
    timer = _Timer(device)
    engine = QueryEngine(EngineConfig())
    meas: dict = {"device": str(device), "quick": quick}
    small = (512, 4096) if quick else (512, 4096, 32768)
    big = 32768 if quick else 1 << 20
    blk_n, blk_q = ((1 << 16, 1 << 14) if quick else (1 << 20, 1 << 17))

    pts = _cloud(big, SEED + 3, device)
    boxes = G.Boxes(pts, pts)
    meas["build"] = {"n": big}
    for eng in ("ref", "pallas"):
        meas["build"][f"{eng}_us"] = timer(
            lambda: lbvh.build(boxes, engine=eng), 3)
    log(f"build n={big}: {meas['build']}")

    rows = []
    for n, q in ((512, 8), (512, 64), (4096, 64), (4096, 256),
                 (32768, 256)):
        if quick and n * q > 1 << 21:
            continue
        index = _index(n, device)
        t = _spatial_times(timer, index, _spheres(q, device), engine)
        rows.append(dict(n=n, q=q, work=n * q, bf_us=t["bf_us"],
                         tree_us=min(t["loop_us"], t["kernel_256_us"])))
        log(f"spatial bf n={n} q={q}: {rows[-1]}")
    meas["spatial_bf"] = rows

    rows = []
    index = _index(4096, device)
    for q in (8, 32, 128, 512):
        t = _spatial_times(timer, index, _spheres(q, device), engine,
                           bf=False)
        rows.append(dict(n=4096, q=q, kernel_us=t["kernel_256_us"],
                         loop_us=t["loop_us"]))
        log(f"spatial kernel n=4096 q={q}: {rows[-1]}")
    for n in small + ((big,) if big not in small else ()):
        t = _spatial_times(timer, _index(n, device), _spheres(256, device),
                           engine, bf=False)
        rows.append(dict(n=n, q=256, kernel_us=t["kernel_256_us"],
                         loop_us=t["loop_us"]))
        log(f"spatial kernel n={n} q=256: {rows[-1]}")
    meas["spatial_kernel"] = rows

    rows = []
    for n in small:
        index = _index(n, device)
        preds = P.nearest(G.Points(_cloud(256, SEED + 5, device)), KNN_K)
        t = _knn_times(timer, index, preds, engine)
        rows.append(dict(n=n, q=256, k=KNN_K, kernel_us=t["kernel_256_us"],
                         loop_us=t["loop_us"]))
        log(f"knn n={n}: {rows[-1]}")
    meas["knn_kernel"] = rows

    rows = []
    for n in small:
        index = _index(n, device)
        t = _callback_times(timer, index, _spheres(1024, device, SEED + 7),
                            engine)
        rows.append(dict(n=n, q=1024, kernel_us=t["kernel_256_us"],
                         loop_us=t["loop_us"]))
        log(f"callback n={n}: {rows[-1]}")
    meas["callback_kernel"] = rows

    # the block sizes at the main path's shape (quick: a sixteenth of it)
    index = _index(blk_n, device)
    spheres = _spheres(blk_q, device, SEED + 8)
    knn = P.nearest(G.Points(_cloud(blk_q, SEED + 9, device)), 10)
    for op, fn, preds in (("spatial", _spatial_times, spheres),
                          ("knn", _knn_times, knn),
                          ("callback", _callback_times, spheres)):
        kw = dict(bf=False) if op == "spatial" else {}
        t = fn(timer, index, preds, engine, loop=False, blocks=BLOCKS,
               reps=5, **kw)
        meas[f"{op}_block"] = {"n": blk_n, "q": blk_q, **{
            str(bq): t[f"kernel_{bq}_us"] for bq in BLOCKS}}
        log(f"{op} block_q n={blk_n} q={blk_q}: {meas[f'{op}_block']}")
    return meas


def _wins(rows):
    return [r["kernel_us"] <= PARITY * r["loop_us"] for r in rows]


def _min_admitted(rows, key):
    """The first `key` of the run of rows (in increasing order) that ends
    at the largest one where the kernel stays within PARITY of the loop:
    0 where the run starts at the smallest row; RT.UNCAPPED (never) where
    the kernel wins at none."""
    rows = sorted(rows, key=lambda r: r[key])
    ok = _wins(rows)
    if not any(ok):
        return RT.UNCAPPED
    first = max(i for i, o in enumerate(ok) if o)
    while first > 0 and ok[first - 1]:
        first -= 1
    return 0 if first == 0 else rows[first][key]


def _max_nodes(rows):
    """A node cap only where the kernel lost at an N above every N where
    it won; else uncapped (0 where it won at none)."""
    won = [r["n"] for r, o in zip(rows, _wins(rows)) if o]
    lost = [r["n"] for r, o in zip(rows, _wins(rows)) if not o]
    if not won:
        return 0
    if any(n > max(won) for n in lost):
        return _pow2_at_least(2 * max(won) - 1)
    return RT.UNCAPPED


def _bf_max_work(rows):
    wins = [r["work"] for r in rows if r["bf_us"] <= r["tree_us"]]
    losses = [r["work"] for r in rows if r["bf_us"] > r["tree_us"]]
    if not wins:
        return 0
    if not losses:
        return RT.UNCAPPED
    return _pow2_at_least(int(math.sqrt(max(wins) * min(losses))))


def _block(times: dict) -> int:
    return min(BLOCKS, key=lambda bq: times[str(bq)])


def derive_rules(meas: dict) -> tuple[dict, str]:
    """({op: RouteRule} with a "default" rule, build engine) from the
    measurements of :func:`measure` (or rows of the same shape)."""
    bf = _bf_max_work(meas["spatial_bf"])
    sp = meas["spatial_kernel"]
    n_fixed = [r for r in sp if r["q"] == 256]
    q_fixed = [r for r in sp if r["n"] == 4096]
    spatial = RT.RouteRule(
        bf_max_work=bf,
        pallas_min_queries=_min_admitted(q_fixed, "q"),
        pallas_min_leaves=_min_admitted(n_fixed, "n"),
        pallas_max_nodes=_max_nodes(n_fixed),
        block_q=_block(meas["spatial_block"]))
    kn = meas["knn_kernel"]
    knn = RT.RouteRule(
        bf_max_work=bf, pallas_min_leaves=_min_admitted(kn, "n"),
        pallas_max_nodes=_max_nodes(kn), block_q=_block(meas["knn_block"]))
    cb = meas["callback_kernel"]
    callback = RT.RouteRule(
        bf_max_work=0,                     # brute force runs no callbacks
        pallas_min_leaves=_min_admitted(cb, "n"),
        pallas_max_nodes=_max_nodes(cb),
        block_q=_block(meas["callback_block"]))
    b = meas["build"]
    build_engine = "pallas" if b["pallas_us"] <= b["ref_us"] else "ref"
    return ({"default": spatial, "spatial": spatial, "knn": knn,
             "callback": callback}, build_engine)


def tune(quick: bool = False, device=None, log=None) -> RT.RouteTable:
    """Measure on `device` and derive a fingerprinted table."""
    with warnings.catch_warnings():
        # an ambient table (perhaps another machine's) must not route the
        # measurements: each timing names its route itself
        warnings.simplefilter("ignore", RuntimeWarning)
        meas = measure(quick=quick, device=device, log=log)
    rules, build_engine = derive_rules(meas)
    return RT.RouteTable(rules=rules, fingerprint=RT.hardware_fingerprint(),
                         build_engine=build_engine, source="autotuned",
                         measurements=meas)


def validate(path: str | None) -> int:
    """The schema check of a persisted table, as an exit status."""
    path = path or RT._default_path()
    if path is None or not os.path.exists(path):
        print("autotune --validate: no persisted route table (the built-in "
              "defaults apply)")
        return 0
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"autotune --validate: {path} is unreadable or corrupt: {e}")
        return 1
    problems = RT.validate_route_table(d)
    if problems:
        print(f"autotune --validate: {path} is invalid:")
        for p in problems:
            print(f"  - {p}")
        return 1
    fp = RT.hardware_fingerprint()
    got = d.get("fingerprint", {})
    if not RT._fingerprints_compatible(got, fp):
        print(f"autotune --validate: {path} is valid but was measured with "
              f"{RT._framework(got)} on {got.get('backend')}/"
              f"{got.get('device_kind')} (this process: torch on "
              f"{fp['backend']}/{fp['device_kind']}); the engine ignores it")
        return 0
    print(f"autotune --validate: {path} OK ({len(d['rules'])} rules, "
          f"build_engine={d.get('build_engine')})")
    return 0


def describe(table: RT.RouteTable) -> list[str]:
    """One line a rule, and the build engine."""
    lines = []
    for op in ("spatial", "knn", "callback"):
        r = table.rule(op)
        cap = lambda v: "uncapped" if v >= RT.UNCAPPED else str(v)
        lines.append(f"{op}: bf_max_work={cap(r.bf_max_work)} "
                     f"min_q={cap(r.pallas_min_queries)} "
                     f"min_n={cap(r.pallas_min_leaves)} "
                     f"max_nodes={cap(r.pallas_max_nodes)} "
                     f"max_capacity={cap(r.pallas_max_capacity)} "
                     f"block_q={r.block_q}")
    lines.append(f"build_engine={table.build_engine}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.autotune",
        description="Measure the routes on this machine and write its "
                    "route table.")
    ap.add_argument("--out", default=None,
                    help="output path (default: ROUTE_TABLE_TORCH.json at "
                         "the checkout's root)")
    ap.add_argument("--quick", action="store_true",
                    help="the smaller grid (under a minute on the card)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--validate", nargs="?", const="", default=None,
                    metavar="PATH", help="check a persisted table and exit")
    args = ap.parse_args(argv)
    if args.validate is not None:
        return validate(args.validate or None)
    log = lambda m: print(f"autotune: {m}", file=sys.stderr)
    table = tune(quick=args.quick, device=args.device, log=log)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    out = args.out or os.path.join(root, RT._DEFAULT_BASENAME)
    table.save(out)
    print(f"autotune: wrote {out}")
    for line in describe(table):
        print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
