"""The PyTorch port stands alone and never falls back quietly:

  * no file of ``src/repro_torch`` (nor ``chip_smoke.py``) imports JAX or
    the JAX package, and the port imports and answers a query with JAX
    blocked;
  * entry points (the LM's too) default to the CUDA card and raise
    without one;
  * a kernel wrapper takes its twin only for CPU tensors: other devices
    raise, and on the card (tests marked ``cuda``) the twin is never
    called.
"""
import ast
import dataclasses
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import (BVH, LM, BruteForce, ExecutionPolicy, convert,
                         dbscan, get_config)
from repro_torch import configs as TCF
from repro_torch.core import callbacks as CB
from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import morton as M
from repro_torch.core import predicates as TP
from repro_torch.core.index import _bcast_state, resolve_device
from repro_torch.kernels import bvh_callback as TC
from repro_torch.kernels import bvh_traverse as TT
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import lbvh_build as TK
from repro_torch.kernels import morton as TM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ray_box as TR
from repro_torch.kernels import ref as TRF
from repro_torch.kernels import sanitize as TS
from repro_torch.models import attention as TA
from repro_torch.models import config as TMC
from repro_torch.models import layers as TLY
from repro_torch.models import lm as TLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch, repro_torch as rt\n"
        "from repro_torch.core.geometry import Points, Spheres\n"
        "pts = torch.rand((64, 3), generator=torch.Generator().manual_seed(0))\n"
        "cfg = rt.EngineConfig(force='kernel')\n"
        "pol = rt.ExecutionPolicy(device='cpu', engine=rt.QueryEngine(cfg))\n"
        "idx = rt.BVH(Points(pts), policy=pol)\n"
        "r = idx.query(rt.intersects(Spheres(pts[:5], torch.full((5,), 0.3))))\n"
        "k = idx.query(rt.nearest(Points(pts[:5]), k=3))\n"
        "assert int(r.offsets[-1]) >= 5 and k.indices[:, 0].tolist() == list(range(5))\n"
        "c = idx.query(rt.intersects(Spheres(pts[:5], torch.full((5,), 0.3))),\n"
        "              callback=rt.callbacks.counting())\n"
        "assert c.tolist() == r.offsets.diff().tolist()\n"
        "labels, core = rt.dbscan(pts, 0.3, 3, policy=pol)\n"
        "rays = rt.Rays(pts[:5], torch.ones((5, 3)))\n"
        "t, i = rt.raytracing.cast_nearest(rt.BVH(rt.Boxes(pts, pts + 0.01), policy=pol),\n"
        "                                  rays)\n"
        "assert t.shape == (5, 1) and bool((t[:, 0] == 0).all())\n"
        "assert labels.shape == (64,) and bool(core.any())\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# no silent CPU or twin fallback
# ---------------------------------------------------------------------------

def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = TG.Points(torch.rand((10, 3)))
    for make in (lambda: BVH(pts), lambda: BruteForce(pts),
                 lambda: BVH(pts, policy=ExecutionPolicy()),
                 lambda: dbscan(pts.coords, 0.1, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert BVH(pts, policy=ExecutionPolicy(device="cpu")).device.type == "cpu"


CALLBACK_TREE = ("node_lo", "node_hi", "rope", "left_child", "range_last",
                 "leaf_perm")


def _tree_args(n=32):
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    return TL.build(TG.Boxes(x, x)), x


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card gets no twin: it raises."""
    t, x = _tree_args()
    meta = {f: getattr(t, f).to("meta") for f in TL.FIELDS}
    q = x[:4].to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        TT.bvh_traverse_spatial(meta["node_lo"], meta["node_hi"], meta["rope"],
                                meta["left_child"], meta["range_last"],
                                meta["leaf_perm"], q, q,
                                torch.zeros((4,), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        TT.bvh_traverse_knn(meta["node_lo"], meta["node_hi"], meta["rope"],
                            meta["left_child"], meta["leaf_perm"], q, k=2)
    k = torch.zeros((8,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TK.karras_ranges(k, k, k, 8, 3)
    with pytest.raises(ValueError, match="no kernel"):
        TM.morton_key(meta["node_lo"], meta["node_hi"])
    with pytest.raises(ValueError, match="no kernel"):
        TK.lbvh_tail(meta["range_first"], meta["range_first"],
                     meta["range_first"], meta["leaf_perm"],
                     meta["node_lo"][:32], meta["node_hi"][:32])
    with pytest.raises(ValueError, match="no kernel"):
        TK.lbvh_refit(meta["left_child"], meta["right_child"], meta["rope"],
                      meta["range_first"], meta["range_last"],
                      meta["leaf_perm"], meta["node_lo"][:32],
                      meta["node_hi"][:32])
    cb, s0 = CB.counting()
    with pytest.raises(ValueError, match="no kernel"):
        TC.bvh_traverse_callback(
            *(meta[f] for f in CALLBACK_TREE), TG.Points(x.to("meta")),
            TP.intersects(TG.Points(q)), cb, _bcast_state(s0, 4, "meta"))
    with pytest.raises(ValueError, match="no kernel"):
        TC.bvh_traverse_callback(
            *(meta[f] for f in CALLBACK_TREE), TG.Points(x.to("meta")),
            TP.RayIntersect(TG.Rays(q, q)), cb, _bcast_state(s0, 4, "meta"))
    with pytest.raises(ValueError, match="no kernel"):
        TR.ray_box_nearest(q, q, q, q)


def test_wrappers_have_no_try_and_count_only_kernel_launches():
    """Read the dispatch: no try/except in the wrappers (no "build failed,
    use the twin"), and a CPU call leaves the launch counters alone."""
    for mod in (TT, TK, TC, TR):
        tree = ast.parse(open(mod.__file__).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), mod
    t, x = _tree_args()
    before = (TK.karras_ranges.launches, TT.bvh_traverse_spatial.launches,
              TT.bvh_traverse_knn.launches, TC.bvh_traverse_callback.launches,
              TR.ray_box_nearest.launches, TK.lbvh_tail.launches,
              TM.morton64.launches)
    TL.refit(TL.build(TG.Boxes(x, x)), TG.Boxes(x, x))
    TT.bvh_traverse_knn(t.node_lo, t.node_hi, t.rope, t.left_child,
                        t.leaf_perm, x[:3], k=2)
    cb, s0 = CB.counting()
    TC.bvh_traverse_callback(*(getattr(t, f) for f in CALLBACK_TREE),
                             TG.Points(x), TP.intersects(TG.Points(x[:3])),
                             cb, _bcast_state(s0, 3, "cpu"))
    TC.bvh_traverse_callback(*(getattr(t, f) for f in CALLBACK_TREE),
                             TG.Points(x), TP.RayIntersect(TG.Rays(x[:3], x[:3])),
                             cb, _bcast_state(s0, 3, "cpu"))
    TR.ray_box_nearest(x[:3], x[:3], x, x + 0.1)
    assert (TK.karras_ranges.launches, TT.bvh_traverse_spatial.launches,
            TT.bvh_traverse_knn.launches, TC.bvh_traverse_callback.launches,
            TR.ray_box_nearest.launches, TK.lbvh_tail.launches,
            TM.morton64.launches) == before


# ---------------------------------------------------------------------------
# on the card (run there with: python -m pytest -m cuda tests/test_torch_*.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_wrappers_on_the_card_never_call_the_twins(cuda_device, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(TT, "bvh_traverse_spatial_ref", boom)
    monkeypatch.setattr(TT, "bvh_traverse_knn_ref", boom)
    monkeypatch.setattr(TK, "karras_ranges_fused", boom)
    monkeypatch.setattr(TK, "lbvh_tail_ref", boom)
    monkeypatch.setattr(TK, "lbvh_refit_ref", boom)
    monkeypatch.setattr(TK, "aabb_rmq", boom)
    monkeypatch.setattr(TM, "morton_key_ref", boom)
    monkeypatch.setattr(M, "_interleave", boom)
    monkeypatch.setattr(TC, "bvh_traverse_callback_ref", boom)
    monkeypatch.setattr(TR, "ray_box_nearest_ref", boom)
    x = torch.rand((500, 3), device=cuda_device)
    t = TL.build(TG.Boxes(x, x))
    TL.refit(t, TG.Boxes(x, x + 0.01))
    r = torch.full((20,), 0.1, device=cuda_device)
    c, _ = TT.bvh_traverse_spatial(t.node_lo, t.node_hi, t.rope, t.left_child,
                                   t.range_last, t.leaf_perm, x[:20], x[:20], r,
                                   capacity=8, fine_sqrt=True)
    d, i = TT.bvh_traverse_knn(t.node_lo, t.node_hi, t.rope, t.left_child,
                               t.leaf_perm, x[:20], k=3)
    cb, s0 = CB.counting()
    s = TC.bvh_traverse_callback(
        *(getattr(t, f) for f in CALLBACK_TREE), TG.Points(x),
        TP.intersects(TG.Spheres(x[:20], r)), cb,
        _bcast_state(s0, 20, cuda_device))
    rays = TP.RayIntersect(TG.Rays(x[:20], x[20:40] - x[:20]))
    sr = TC.bvh_traverse_callback(
        *(getattr(t, f) for f in CALLBACK_TREE), TG.Points(x), rays, cb,
        _bcast_state(s0, 20, cuda_device))
    tb, ib = TR.ray_box_nearest(x[:20], x[20:40] - x[:20], x, x + 0.01)
    torch.cuda.synchronize()
    assert bool((c >= 1).all()) and i[:, 0].tolist() == list(range(20))
    assert torch.equal(s, c)
    # every ray starts at a point of the cloud: t = 0 hits on both
    assert bool((sr >= 1).all()) and bool((tb == 0).all() & (ib >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 17, 5000])
def test_kernels_match_twins_on_the_card(cuda_device, n):
    g = torch.Generator().manual_seed(n)
    x = torch.rand((n, 3), generator=g)
    x[::4] = x[0].clone()                            # duplicate codes
    cpu_tree = TL.build(TG.Boxes(x, x))
    gx = x.to(cuda_device)
    gpu_tree = TL.build(TG.Boxes(gx, gx))
    for f in TL.FIELDS:
        assert torch.equal(getattr(cpu_tree, f), getattr(gpu_tree, f).cpu()), f
    q = torch.rand((300, 3), generator=g)
    r = torch.full((300,), 0.2)
    for fine_sqrt in (False, True):
        a = TT.bvh_traverse_spatial(*(getattr(cpu_tree, f) for f in (
            "node_lo", "node_hi", "rope", "left_child", "range_last",
            "leaf_perm")), q, q, r, capacity=6, fine_sqrt=fine_sqrt)
        b = TT.bvh_traverse_spatial(*(getattr(gpu_tree, f) for f in (
            "node_lo", "node_hi", "rope", "left_child", "range_last",
            "leaf_perm")), q.to(cuda_device), q.to(cuda_device),
            r.to(cuda_device), capacity=6, fine_sqrt=fine_sqrt)
        assert all(torch.equal(u, v.cpu()) for u, v in zip(a, b))
    for k in (1, 10, 33):
        a = TT.bvh_traverse_knn(cpu_tree.node_lo, cpu_tree.node_hi,
                                cpu_tree.rope, cpu_tree.left_child,
                                cpu_tree.leaf_perm, q, k=k)
        b = TT.bvh_traverse_knn(gpu_tree.node_lo, gpu_tree.node_hi,
                                gpu_tree.rope, gpu_tree.left_child,
                                gpu_tree.leaf_perm, q.to(cuda_device), k=k)
        assert all(torch.equal(u, v.cpu()) for u, v in zip(a, b))


def _callback_case(vkind, qkind, name, dev, n=3000, q=400, seed=0, dim=3):
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((n, dim), generator=g)
    values = {"points": TG.Points(c),
              "boxes": TG.Boxes(c, c + 0.03 * torch.rand((n, dim), generator=g)),
              "spheres": TG.Spheres(c, 0.03 * torch.rand((n,), generator=g))}[vkind]
    qc = torch.rand((q, dim), generator=g)
    qc[::3] = c[:q:3]                                  # exact point hits
    geom = {"points": TG.Points(qc), "boxes": TG.Boxes(qc, qc + 0.08),
            "spheres": TG.Spheres(qc, torch.full((q,), 0.06))}[qkind]
    flags = torch.rand((n,), generator=g) < 0.5
    weights = torch.randint(0, 10 * n, (n,), generator=g, dtype=torch.int32)
    cb, s0 = {"counting": CB.counting, "min_distance": CB.min_distance,
              "count_with_limit": lambda: CB.count_with_limit(5),
              "collect_first_k": lambda: CB.collect_first_k(8),
              "collect_hits": lambda: CB.collect_hits(32),
              "min_where": lambda: CB._min_where(flags, weights, 10**9)}[name]()
    values = values.to(dev)
    tree = TL.build(TG.to_boxes(values))
    if name == "min_where":
        cb = CB._min_where(flags.to(dev), weights.to(dev), 10**9)[0]
    return ([getattr(tree, f) for f in CALLBACK_TREE], values,
            TP.intersects(geom.to(dev)), cb, _bcast_state(s0, q, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("qkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("name", ["counting", "count_with_limit",
                                  "min_distance", "collect_first_k",
                                  "collect_hits", "min_where"])
def test_callback_kernel_matches_twin_on_the_card(cuda_device, name, vkind,
                                                  qkind):
    """Every epilogue over every (predicate, value) geometry pair: the
    kernel's final states equal its twin's bit for bit."""
    args = _callback_case(vkind, qkind, name, cuda_device)
    before = TC.bvh_traverse_callback.launches
    got = TC.bvh_traverse_callback(*args[0], *args[1:])
    torch.cuda.synchronize()
    assert TC.bvh_traverse_callback.launches == before + 1
    want = TC.bvh_traverse_callback_ref(*args[0], *args[1:])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _states_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3, 5])
@pytest.mark.parametrize("qkind,vkind", [("spheres", "points"),
                                         ("boxes", "boxes"),
                                         ("points", "spheres")])
@pytest.mark.parametrize("name", ["counting", "count_with_limit",
                                  "min_distance", "collect_first_k",
                                  "collect_hits", "min_where"])
def test_callback_kernel_instances_with_min_pos_on_the_card(
        cuda_device, name, qkind, vkind, dim):
    """The dim = 3 instance (packed records, leaf tests from node tests)
    and the generic one (dims 2 and 5), each under a min_pos filter (the
    range_last read), against the twin bit for bit."""
    args = _callback_case(vkind, qkind, name, cuda_device, dim=dim)
    q = len(args[2])
    mp = torch.randint(-1, 3000, (q,), generator=torch.Generator()
                       .manual_seed(dim)).to(torch.int32).to(cuda_device)
    for min_pos in (None, mp):
        got = TC.bvh_traverse_callback(*args[0], *args[1:], min_pos=min_pos)
        want = TC.bvh_traverse_callback_ref(*args[0], *args[1:],
                                            min_pos=min_pos)
        assert _states_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["count_with_limit", "min_where"])
def test_callback_kernel_on_a_clustered_cloud_on_the_card(cuda_device, name):
    """DBSCAN's two walks at Q = N = 2^14 on a clustered 3-D cloud,
    queries centred on the indexed points (the leaf order walks them):
    identical to the twin."""
    g = torch.Generator().manual_seed(14)
    centres = 0.1 + 0.8 * torch.rand((16, 3), generator=g)
    c = (centres[:, None] + 0.01 * torch.randn((16, 1 << 10, 3), generator=g))
    c = c.reshape(-1, 3).to(cuda_device)
    n = c.shape[0]
    index = BVH(TG.Points(c), policy=ExecutionPolicy(device=cuda_device))
    t = index.tree
    preds = TP.intersects(TG.Spheres(c, torch.full((n,), 0.003,
                                                   device=cuda_device)))
    flags = torch.rand((n,), generator=g).to(cuda_device) < 0.7
    labels = torch.randint(0, n, (n,), generator=g, dtype=torch.int32)
    cb, s0 = (CB.count_with_limit(3) if name == "count_with_limit" else
              CB._min_where(flags, labels.to(cuda_device), 2**31 - 1))
    s0 = _bcast_state(s0, n, cuda_device)
    args = ([getattr(t, f) for f in CALLBACK_TREE], index.values, preds, cb, s0)
    got = TC.bvh_traverse_callback(*args[0], *args[1:])
    want = TC.bvh_traverse_callback_ref(*args[0], *args[1:])
    assert _states_equal(got, want)
    assert int(got.max() if name == "count_with_limit" else
               (got < 2**31 - 1).sum()) > 0


def _ray_case(vkind, name, dev, n=3000, q=500, seed=0):
    """A ray callback call: seeded values, rays from the unit cube (a
    third aimed at a value, a tenth with a zero direction component)."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((n, 3), generator=g)
    e = 0.03 * (torch.rand((n, 3), generator=g) - 0.5)
    values = {"points": TG.Points(c),
              "boxes": TG.Boxes(c, c + 0.03 * torch.rand((n, 3), generator=g)),
              "spheres": TG.Spheres(c, 0.03 * torch.rand((n,), generator=g)),
              "triangles": TG.Triangles(c, c + e, c + e.roll(1, 1))}[vkind]
    o = torch.rand((q, 3), generator=g)
    d = torch.randn((q, 3), generator=g)
    d[::3] = c[:q:3] - o[::3]
    d[1::10, 0] = 0.0
    flags = torch.rand((n,), generator=g) < 0.5
    weights = torch.randint(0, 10 * n, (n,), generator=g, dtype=torch.int32)
    cb, s0 = {"counting": CB.counting, "min_distance": CB.min_distance,
              "count_with_limit": lambda: CB.count_with_limit(3),
              "collect_first_k": lambda: CB.collect_first_k(4),
              "collect_hits": lambda: CB.collect_hits(32),
              "min_where": lambda: CB._min_where(flags, weights, 10**9)}[name]()
    values = values.to(dev)
    tree = TL.build(TG.to_boxes(values))
    if name == "min_where":
        cb = CB._min_where(flags.to(dev), weights.to(dev), 10**9)[0]
    return ([getattr(tree, f) for f in CALLBACK_TREE], values,
            TP.RayIntersect(TG.Rays(o, d).to(dev)), cb,
            _bcast_state(s0, q, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres", "triangles"])
@pytest.mark.parametrize("name", ["counting", "count_with_limit",
                                  "min_distance", "collect_first_k",
                                  "collect_hits", "min_where"])
def test_ray_callback_kernel_matches_twin_on_the_card(cuda_device, name,
                                                      vkind):
    """The ray instances of the callback kernel, every epilogue over every
    value geometry: final states (the ray parameter t included) equal the
    twin's bit for bit."""
    args = _ray_case(vkind, name, cuda_device)
    before = TC.bvh_traverse_callback.launches
    got = TC.bvh_traverse_callback(*args[0], *args[1:])
    torch.cuda.synchronize()
    assert TC.bvh_traverse_callback.launches == before + 1
    want = TC.bvh_traverse_callback_ref(*args[0], *args[1:])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name == "counting":
        assert int(got[0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("r,b", [(1, 1), (129, 257), (1000, 3001), (1, 0),
                                 (3, 3), (1000, 255), (1025, 257),
                                 (1029, 4097), (2049, 1)])
def test_ray_box_nearest_matches_twin_on_the_card(cuda_device, r, b):
    """ray_box_nearest against its twin: t and index bit-identical, with
    duplicated boxes (ties), misses, zero direction components, origins
    inside a box (t = 0) and R, B that are not multiples of the block,
    the rays of a block or the tile (B = 0, a ragged tile alone, one box
    past whole tiles, the box axis split across blocks)."""
    g = torch.Generator().manual_seed(r + b)
    lo = torch.rand((b, 3), generator=g)
    hi = lo + 0.05 * torch.rand((b, 3), generator=g)
    lo[1::4], hi[1::4] = lo[::4][:lo[1::4].shape[0]], hi[::4][:hi[1::4].shape[0]]
    o = torch.rand((r, 3), generator=g)
    d = torch.randn((r, 3), generator=g)
    d[::5, 1] = 0.0
    if b:
        inside = torch.arange(2, max(r, 2), 6)          # t = 0
        o[inside] = 0.5 * (lo + hi)[inside % b]
    o[::7] = o[::7] + 5.0                               # misses
    args = [a.to(cuda_device) for a in (o, d, lo, hi)]
    before = TR.ray_box_nearest.launches
    t, i = TR.ray_box_nearest(*args)
    torch.cuda.synchronize()
    assert TR.ray_box_nearest.launches == before + 1
    wt, wi = TR.ray_box_nearest_ref(o, d, lo, hi)
    assert torch.equal(t.cpu(), wt) and torch.equal(i.cpu(), wi)


# ---------------------------------------------------------------------------
# slice 4: the stand-alone kernel ops, the sanitizer, convert's default
# ---------------------------------------------------------------------------

TB = importlib.import_module("repro_torch.kernels.bruteforce_knn")
NEW_MODULES = (TM, TB, TO, TRF, TS, TF, TCF, TMC, TLY, TA, TLM)


def test_kernel_ops_run_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "from repro_torch.kernels import ops, ref, sanitize\n"
        "x = torch.rand((300, 3), generator=torch.Generator().manual_seed(0))\n"
        "hi, lo = ops.morton64(x)\n"
        "d, i = ops.bruteforce_knn(x[:7], x, 4)\n"
        "assert i[:, 0].tolist() == list(range(7)) and hi.shape == (300,)\n"
        "assert torch.equal(ref.bruteforce_knn_ref(x[:7], x, 4)[1], i)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in NEW_MODULES + LAUNCH_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


LAUNCH_MODULES = tuple(importlib.import_module(f"repro_torch.launch.{m}")
                       for m in ("mesh", "sharding", "specs", "opanalysis",
                                 "dryrun", "train"))


def test_launch_modules_run_with_jax_blocked():
    """The mesh, sharding, specs, analysis and dry-run modules import and
    work with JAX and the reference blocked: a production mesh's specs, a
    counted product, and a dry-run cell on a fake world."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import dryrun, mesh, opanalysis, sharding, specs\n"
        "m = mesh.AbstractMesh((16, 16), ('data', 'model'))\n"
        "model = specs.params_struct(get_config('tinyllama-1.1b'))\n"
        "ps = sharding.param_specs(model, m)\n"
        "assert ps['layers.0.attn.wq'] == (None, 'model')\n"
        "assert sharding.zero1_specs(ps, model, m)['embed.table'] == ('model', 'data')\n"
        "r = opanalysis.analyze(torch.mm, torch.ones(4, 8), torch.ones(8, 2))\n"
        "assert r['flops'] == 2 * 4 * 8 * 2\n"
        "rec = dryrun.run_cell('mamba2-780m', 'long_500k', verbose=False)\n"
        "assert rec['status'] == 'ok', rec\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_convert_defaults_to_the_card(monkeypatch):
    """With no card, the no-argument calls raise resolve_device's error;
    a missing tree field still raises KeyError first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    t, _ = _tree_args()
    fields = convert.lbvh_to_numpy(t)
    with pytest.raises(RuntimeError) as got:
        convert.lbvh_from_numpy(fields)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError) as got:
        convert.geometry_from_numpy("points", [fields["node_lo"]])
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError):
        convert.lbvh_from_numpy({"node_lo": fields["node_lo"]})
    assert convert.lbvh_from_numpy(fields, "cpu").node_lo.device.type == "cpu"


def test_new_wrappers_refuse_other_devices():
    q = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TM.morton64(q, q[0], q[0])
    with pytest.raises(ValueError, match="no kernel"):
        TB.bruteforce_knn(q, q, 2)
    a = torch.zeros((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TF.flash_attention(a, a, a)


def test_new_wrappers_have_no_try_and_count_only_kernel_launches():
    for mod in NEW_MODULES:
        tree = ast.parse(open(mod.__file__).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), mod
    x = torch.rand((50, 3), generator=torch.Generator().manual_seed(3))
    a = torch.rand((1, 2, 8, 16), generator=torch.Generator().manual_seed(4))
    before = (TM.morton64.launches, TB.bruteforce_knn.launches,
              TF.flash_attention.launches)
    TO.morton64(x)
    TO.bruteforce_knn(x[:5], x, 3)
    TO.flash_attention(a, a, a)
    assert (TM.morton64.launches, TB.bruteforce_knn.launches,
            TF.flash_attention.launches) == before


@pytest.mark.cuda
def test_new_wrappers_on_the_card_never_call_the_twins(cuda_device,
                                                       monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(TM, "morton64_ref", boom)
    monkeypatch.setattr(TB, "bruteforce_knn_ref", boom)
    x = torch.rand((500, 3), device=cuda_device)
    hi, lo = TO.morton64(x)
    d, i = TO.bruteforce_knn(x[:20], x, 3)
    torch.cuda.synchronize()
    assert hi.shape == (500,) and i[:, 0].tolist() == list(range(20))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim", [(1, 3), (1000, 1), (4099, 2), (5000, 3),
                                   (777, 6), (300, 10), (200, 21)])
def test_morton_kernel_matches_twin_on_the_card(cuda_device, n, dim):
    g = torch.Generator().manual_seed(n + dim)
    x = torch.rand((n, dim), generator=g) * 4 - 1
    lo, hi = torch.zeros(dim), torch.ones(dim)      # points outside clamp
    before = TM.morton64.launches
    got = TM.morton64(x.to(cuda_device), lo.to(cuda_device),
                      hi.to(cuda_device))
    torch.cuda.synchronize()
    assert TM.morton64.launches == before + 1
    want = TM.morton64_ref(x, lo, hi)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    core = M.morton64(x.to(cuda_device), lo.to(cuda_device),
                      hi.to(cuda_device))
    assert all(torch.equal(a, b) for a, b in zip(got, core))


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,dim,k,bn", [
    (1, 1, 3, 1, 512), (100, 300, 3, 8, 512), (257, 2000, 3, 10, 512),
    (70, 1000, 2, 32, 512), (65, 700, 5, 33, 512), (40, 600, 17, 4, 512),
    (30, 100, 64, 16, 512), (20, 5, 3, 8, 512), (20, 513, 3, 256, 512),
    (33, 200, 3, 256, 64), (64, 3000, 3, 256, 512)])
def test_bruteforce_kernel_matches_twin_on_the_card(cuda_device, q, n, dim,
                                                    k, bn):
    """Distances and indices bit-identical to the twin: register and
    local-memory lists, dims in registers and read from memory, duplicate
    points (ties), and the k > N tail in one panel and in several."""
    g = torch.Generator().manual_seed(q + n + k)
    p = torch.rand((n, dim), generator=g)
    p[1::3] = p[::3][:p[1::3].shape[0]].clone()
    qs = torch.cat([p[:q // 2], torch.rand((q - q // 2, dim), generator=g)])
    before = TB.bruteforce_knn.launches
    got = TB.bruteforce_knn(qs.to(cuda_device), p.to(cuda_device), k, bn=bn)
    torch.cuda.synchronize()
    assert TB.bruteforce_knn.launches == before + 1
    want = TB.bruteforce_knn_ref(qs, p, k, bn=bn)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    if k > n:
        assert bool(torch.isinf(got[0][:, n:]).all())


# ---------------------------------------------------------------------------
# slice 5: the LM forward and the flash-attention kernel
# ---------------------------------------------------------------------------

SMOKE = "tinyllama-1.1b"


def _lm_tree(model):
    """A CPU LM's weights as the reference's numpy parameter tree: the
    blocks' leaves stacked along a leading layer axis."""
    tree = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            if parts[1] != "0":
                continue
            parts = ["layers"] + parts[2:]
            a = np.stack([dict(model.named_parameters())[
                ".".join(["layers", str(i)] + parts[1:])].detach().numpy()
                for i in range(len(model.layers))])
        else:
            a = p.detach().numpy()
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = a
    return tree


def test_lm_entry_points_default_to_the_card(monkeypatch):
    """LM.from_config, LM() and convert.lm_from_numpy take the card when no
    device is given, and raise resolve_device's error without one."""
    cfg = get_config(SMOKE, smoke=True)
    cpu = LM.from_config(cfg, seed=0, device="cpu")
    tree = _lm_tree(cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    for make in (lambda: LM.from_config(cfg), lambda: LM(cfg),
                 lambda: convert.lm_from_numpy(cfg, tree)):
        with pytest.raises(RuntimeError) as got:
            make()
        assert str(got.value) == str(want.value)
    back = convert.lm_from_numpy(cfg, tree, "cpu")
    assert back.device.type == "cpu"
    for (name, a), b in zip(cpu.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name


def test_lm_forward_runs_with_jax_blocked():
    code = (
        "import sys, dataclasses\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch, repro_torch as rt\n"
        f"cfg = rt.get_config({SMOKE!r}, smoke=True)\n"
        "tok = torch.randint(0, cfg.vocab, (2, 70),\n"
        "                    generator=torch.Generator().manual_seed(0))\n"
        "out = {}\n"
        "for impl in ('xla', 'flash'):\n"
        "    c = dataclasses.replace(cfg, attn_impl=impl)\n"
        "    m = rt.LM.from_config(c, seed=0, device='cpu')\n"
        "    with torch.inference_mode():\n"
        "        out[impl], aux = m(tok)\n"
        "assert out['xla'].shape == (2, 70, cfg.vocab) and float(aux) == 0\n"
        "gap = (out['xla'] - out['flash']).abs().max()\n"
        "assert float(gap) <= 1e-5 * float(out['xla'].abs().max()), gap\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: (B, Hq, Hkv, Sq, Skv, D, causal, window): the reference's sweep, Sq >
#: Skv, the kernel's other head widths (112: zamba2-7b's; 80 pads to 128
#: in 16 bits and has no float32 instance), ragged tiles
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True, None), (2, 8, 2, 128, 128, 64, True, None),
    (1, 4, 1, 256, 256, 32, True, None), (1, 4, 4, 100, 100, 64, True, None),
    (1, 2, 2, 64, 192, 64, True, None), (1, 4, 2, 128, 128, 64, True, 32),
    (1, 2, 2, 96, 96, 128, False, None), (1, 4, 2, 192, 64, 64, True, None),
    (1, 4, 2, 300, 300, 96, True, None), (2, 4, 2, 77, 77, 16, True, 10),
    (1, 4, 4, 200, 200, 112, True, None), (1, 4, 2, 150, 150, 80, True, 64),
]
#: output type -> relative step: kernel and twin round two float32 values
#: that differ in their last bits, so their outputs may differ by a step
FLASH_STEP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
              torch.float16: 2.0 ** -10}
#: output type -> unit roundoff of p: the tensor-core kernel rounds p to
#: the input type before P.V, the twin keeps it in float32
FLASH_P_ROUND = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
                 torch.float16: 2.0 ** -11}


def flash_tolerance(q, k, v, want, causal, window):
    """2e-5 + 2 steps of |want| + u * ref(q, k, |v|): float32 sums in other
    orders and one rounding each, plus p rounded to the input type (each
    p off by at most u p, so each output by at most u times the p-weighted
    mean of |v|, which is the twin applied to |v| in float32)."""
    tol = 2e-5 + 2 * FLASH_STEP[q.dtype] * want.abs()
    if FLASH_P_ROUND[q.dtype]:
        mean_abs = TF.flash_attention_ref(q.float(), k.float(),
                                          v.float().abs(), causal=causal,
                                          window=window)
        tol = tol + FLASH_P_ROUND[q.dtype] * mean_abs
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_twin_on_the_card(cuda_device, case, dtype):
    """Within flash_tolerance; a head width the kernel does not take in
    this dtype raises, naming the widths it takes."""
    b, hq, hkv, sq, skv, d, causal, window = case
    g = torch.Generator().manual_seed(sq + skv + d)
    q = torch.randn((b, hq, sq, d), generator=g).to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=g).to(dtype)
    v = torch.randn((b, hkv, skv, d), generator=g).to(dtype)
    before = TF.flash_attention.launches
    if not TF.kernel_takes(d, dtype):
        with pytest.raises(ValueError, match="head widths"):
            TF.flash_attention(*(x.to(cuda_device) for x in (q, k, v)),
                               causal=causal, window=window)
        assert TF.flash_attention.launches == before
        return
    got = TF.flash_attention(*(x.to(cuda_device) for x in (q, k, v)),
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert TF.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = TF.flash_attention_ref(q, k, v, causal=causal, window=window)
    got, want = got.cpu().float(), want.float()
    tol = flash_tolerance(q, k, v, want, causal, window)
    assert bool(((got - want).abs() <= tol).all())
    if sq > skv and causal:
        assert bool((got[:, :, :sq - skv] == 0).all())


@pytest.mark.cuda
def test_lm_forward_on_the_card_launches_flash_per_layer(cuda_device,
                                                         monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(TF, "flash_attention_ref", boom)
    cfg = dataclasses.replace(get_config(SMOKE, smoke=True), attn_impl="flash")
    model = LM.from_config(cfg, seed=0)
    assert model.device.type == "cuda"
    tok = torch.randint(0, cfg.vocab, (2, 100), device=cuda_device)
    before = TF.flash_attention.launches
    with torch.inference_mode():
        logits, _ = model(tok)
    torch.cuda.synchronize()
    assert TF.flash_attention.launches == before + cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="forward-only"):
        model(tok)                                   # grad mode on


# ---------------------------------------------------------------------------
# slice 8: the nearest-first kNN walk and the split brute force
# ---------------------------------------------------------------------------

#: k values that reach every list bucket of the walk (1, 2, 4, 8, 16, 32
#: in registers, the heap above)
KNN_BUCKETS = (1, 2, 3, 8, 10, 32, 33, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 17, 5000])
@pytest.mark.parametrize("dim", [1, 2, 3, 5, 16])
def test_knn_walk_matches_twin_on_the_card(cuda_device, n, dim):
    """The nearest-first walk against the rope-walk twin, torch.equal on
    distances and indices: the 3-D records instance (records kept with
    the tree, and packed by the wrapper) and the any-dim instance (dims 1,
    2, 5, 16), every k bucket, duplicate points (ties at the k-th
    distance, the tie pass), inf and NaN queries, queries in the caller's
    order and in a computed order, and the points themselves in the leaf
    order."""
    g = torch.Generator().manual_seed(n + dim)
    x = torch.rand((n, dim), generator=g)
    x[::4] = x[0].clone()                            # duplicate codes
    tree = TL.build(TG.Boxes(x, x))
    q = torch.cat([x[torch.randint(0, n, (100,), generator=g)],
                   torch.rand((100, dim), generator=g)])
    q[0, 0], q[1, -1] = float("inf"), float("nan")
    gt = tree.to(cuda_device)
    gq, gx = q.to(cuda_device), x.to(cuda_device)
    args = (gt.node_lo, gt.node_hi, gt.rope, gt.left_child, gt.leaf_perm)
    twin_args = (tree.node_lo, tree.node_hi, tree.rope, tree.left_child,
                 tree.leaf_perm)
    shuffled = torch.randperm(len(q), generator=g).to(torch.int32)
    self_order = TT.knn_order(gx, gx, gt.leaf_perm)
    assert self_order is gt.leaf_perm
    ks = KNN_BUCKETS if n < 5000 or dim == 3 else (1, 10, 33, 256)
    for k in ks:
        want = TT.bvh_traverse_knn_ref(*twin_args, q, k=k)
        runs = [{}, {"order": shuffled.to(cuda_device)}]
        if dim == 3:
            runs.append({"records": gt.records})
        for kw in runs:
            before = TT.bvh_traverse_knn.launches
            got = TT.bvh_traverse_knn(*args, gq, k=k, **kw)
            torch.cuda.synchronize()
            assert TT.bvh_traverse_knn.launches == before + 1
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), \
                (k, sorted(kw))
        if k in (1, 10, 33):
            want = TT.bvh_traverse_knn_ref(*twin_args, x, k=k)
            got = TT.bvh_traverse_knn(*args, gx, k=k, order=self_order)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), k


@pytest.mark.cuda
def test_bvh_nearest_on_the_card_passes_records_and_the_leaf_order(
        cuda_device, monkeypatch):
    """BVH.query(nearest) hands the kNN kernel the tree's kept records and,
    for the indexed points themselves, the leaf order; results equal the
    CPU index's."""
    from repro_torch.core import engine as TE
    seen = []
    real = TE.bvh_traverse_knn

    def spy(*a, **kw):
        seen.append((kw.get("records"), kw.get("order")))
        return real(*a, **kw)

    monkeypatch.setattr(TE, "bvh_traverse_knn", spy)
    x = torch.rand((3000, 3), generator=torch.Generator().manual_seed(8))
    x[::4] = x[0].clone()
    gx = x.to(cuda_device)
    engine = TE.QueryEngine(TE.EngineConfig(force="kernel"))
    index = BVH(TG.Points(gx), policy=ExecutionPolicy(device=cuda_device),
                engine=engine)
    host = BVH(TG.Points(x), policy=ExecutionPolicy(device="cpu"),
               engine=engine)
    t = index.tree
    for pts, self_query in ((gx, True), (gx[:500].clone(), False)):
        got = index.query(TP.nearest(TG.Points(pts), k=7))
        records, order = seen[-1]
        want = host.query(TP.nearest(TG.Points(pts.cpu()), k=7))
        assert records is t.records
        assert (order is t.leaf_perm) == self_query
        assert self_query or order is None
        assert torch.equal(got.indices.cpu(), want.indices)
        assert torch.equal(got.distances.cpu(), want.distances)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,dim,k,bn,chunk", [
    (1, 5000, 3, 10, 512, 512),        # Q = 1: one query tile, 10 rows
    (8192, 3000, 3, 10, 512, 512),     # the Q = 2^13 grid: 64 query tiles
    (100, 3001, 3, 8, 512, 700),       # N no multiple of the chunk
    (100, 3072, 3, 8, 512, 512),       # tail_from (2560) at a chunk edge
    (100, 3000, 3, 8, 512, 1000),      # tail_from inside the chunk run
    (50, 300, 3, 256, 128, 64),        # k > N over three panels, split
    (50, 300, 3, 200, 64, 100),        # k > N over five panels, split
    (64, 5000, 3, 256, 512, 1024),     # k = 256 (the heap) with S > 1
    (64, 5000, 5, 33, 512, 512),       # registers dims, the heap
    (64, 4000, 17, 16, 512, 512),      # wide rows (read through the cache)
    (64, 2000, 2, 32, 512, 256),
    (64, 5000, 3, 10, 512, 5000),      # one chunk: the scan writes it
])
def test_split_bruteforce_matches_twin_on_the_card(cuda_device, q, n, dim, k,
                                                   bn, chunk):
    """The split scan and its merge, called with a chunk of points per
    block row: bit-identical to the twin, the k > N tail included."""
    g = torch.Generator().manual_seed(q + n + k)
    p = torch.rand((n, dim), generator=g)
    p[1::3] = p[::3][:p[1::3].shape[0]].clone()
    qs = torch.cat([p[:q // 2], torch.rand((q - q // 2, dim), generator=g)])
    tail = TB.tail_from(n, bn)
    assert (TB.splits(n, tail, chunk) > 1) == (chunk < n)
    before = TB.bruteforce_knn.launches
    got = TB._launch(qs.to(cuda_device), p.to(cuda_device), k, tail, chunk)
    torch.cuda.synchronize()
    assert TB.bruteforce_knn.launches == before + 1
    want = TB.bruteforce_knn_ref(qs, p, k, bn=bn)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the ray kNN kernel and the callback kernel's 3-D ray walk
# ---------------------------------------------------------------------------

def test_ray_knn_wrapper_refuses_other_devices_and_counts_only_launches():
    """bvh_traverse_ray_knn: a meta tensor raises, a CPU call takes the
    twin and leaves the launch counter alone."""
    t, x = _tree_args()
    tree = [getattr(t, f) for f in ("node_lo", "node_hi", "rope",
                                    "left_child", "leaf_perm")]
    rays = TG.Rays(x[:4], x[4:8] - x[:4])
    with pytest.raises(ValueError, match="no kernel"):
        TT.bvh_traverse_ray_knn(*(a.to("meta") for a in tree),
                                TG.Points(x.to("meta")), rays.to("meta"), k=2)
    before = TT.bvh_traverse_ray_knn.launches
    ti, ii = TT.bvh_traverse_ray_knn(*tree, TG.Points(x), rays, k=2)
    assert TT.bvh_traverse_ray_knn.launches == before
    # each ray starts on a point of the cloud: a hit at t = 0 first
    assert bool((ti[:, 0] == 0).all()) and bool((ii[:, 0] >= 0).all())


@pytest.mark.cuda
def test_ray_knn_on_the_card_never_calls_the_twin(cuda_device, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(TT, "bvh_traverse_ray_knn_ref", boom)
    x = torch.rand((500, 3), device=cuda_device)
    t = TL.build(TG.Boxes(x, x))
    tree = [getattr(t, f) for f in ("node_lo", "node_hi", "rope",
                                    "left_child", "leaf_perm")]
    ti, ii = TT.bvh_traverse_ray_knn(*tree, TG.Points(x),
                                     TG.Rays(x[:20], x[20:40] - x[:20]), k=3)
    torch.cuda.synchronize()
    assert bool((ti[:, 0] == 0).all()) and ii[:, 0].tolist() == list(range(20))


@pytest.mark.cuda
@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres", "triangles"])
@pytest.mark.parametrize("name", ["counting", "count_with_limit",
                                  "min_distance", "collect_first_k",
                                  "collect_hits", "min_where"])
def test_ray_callback_kernel_with_kept_records_on_the_card(cuda_device, name,
                                                           vkind):
    """The 3-D ray walk with the caller's kept node and value records:
    final states equal the twin's bit for bit."""
    args = _ray_case(vkind, name, cuda_device, seed=1)
    tree, values = args[0], args[1]
    records = TT.pack_nodes(tree[0], tree[1], tree[2], tree[3], tree[5])
    got = TC.bvh_traverse_callback(
        *tree, *args[1:], records=records,
        value_records=TT.pack_values(values, tree[5]))
    torch.cuda.synchronize()
    want = TC.bvh_traverse_callback_ref(*tree, *args[1:])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("dim", [2, 5])
def test_ray_callback_generic_instance_on_the_card(cuda_device, vkind, dim):
    """Other dims: the any-dim ray walk, for counting and collect_hits."""
    g = torch.Generator().manual_seed(dim)
    n, q = 2000, 300
    c = torch.rand((n, dim), generator=g)
    values = {"points": TG.Points(c), "boxes": TG.Boxes(c, c + 0.05),
              "spheres": TG.Spheres(c, torch.full((n,), 0.04))}[vkind]
    o = torch.rand((q, dim), generator=g)
    d = torch.randn((q, dim), generator=g)
    d[::3] = c[:q:3] - o[::3]
    d[1::7, 0] = 0.0
    values = values.to(cuda_device)
    rays = TG.Rays(o, d).to(cuda_device)
    tree = TL.build(TG.to_boxes(values))
    args = [getattr(tree, f) for f in CALLBACK_TREE]
    for make in (CB.counting, lambda: CB.collect_hits(16)):
        cb, s0 = make()
        s0 = _bcast_state(s0, q, cuda_device)
        want = TC.bvh_traverse_callback_ref(*args, values,
                                            TP.RayIntersect(rays), cb, s0)
        want = want if isinstance(want, tuple) else (want,)
        got = TC.bvh_traverse_callback(*args, values, TP.RayIntersect(rays),
                                       cb, s0)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_ray_callback_entry_refuses_3d_rays_without_records(cuda_device):
    """bvh_callback_launch takes a 3-D ray call only with the tree's node
    records (the 3-D instance), and no ray call with a walk order."""
    from repro_torch.kernels import _build
    tree, values, preds, cb, s0 = _ray_case("triangles", "counting",
                                            cuda_device, seed=2)
    rays = preds.rays
    q, n = rays.origin.shape[0], tree[5].shape[0]
    records = TT.pack_nodes(tree[0], tree[1], tree[2], tree[3], tree[5])
    vrec = TT.pack_values(values, tree[5])
    order = torch.arange(q, dtype=torch.int32, device=cuda_device)
    mp = torch.full((q,), -1, dtype=torch.int32, device=cuda_device)
    out = s0.contiguous().clone()
    fn = _build.function("bvh_callback", "bvh_callback_launch", TC._ARGS)

    def launch(rec, order_):
        return fn(*(x.data_ptr() for x in tree),
                  None if rec is None else rec.data_ptr(), vrec.data_ptr(),
                  None if order_ is None else order_.data_ptr(),
                  rays.origin.data_ptr(), rays.direction.data_ptr(), None,
                  values.a.data_ptr(), values.b.data_ptr(),
                  values.c.data_ptr(), None, None, mp.data_ptr(), n, q, 3, 4,
                  3, 0,
                  0, 0, out.data_ptr(), None, None, None,
                  torch.cuda.current_stream(cuda_device).cuda_stream)

    assert launch(None, None) != 0
    assert launch(records, order) != 0
    assert launch(records, None) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, TC.bvh_traverse_callback_ref(*tree, values,
                                                         preds, cb, s0))


# ---------------------------------------------------------------------------
# the serving slice: telemetry, the engine's executable cache, the service
# ---------------------------------------------------------------------------

SERVING_MODULES = tuple(importlib.import_module(f"repro_torch.{m}") for m in (
    "telemetry", "telemetry.tracer", "telemetry.metrics", "telemetry.export",
    "telemetry.report", "service", "service.batcher", "service.index_store",
    "service.server", "service.pipeline"))


def test_serving_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in SERVING_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


def test_service_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch import telemetry\n"
        "from repro_torch.core.geometry import Points\n"
        "from repro_torch.service import (QueryServer, ServingPipeline,\n"
        "    knn_request, ray_request, within_request)\n"
        "telemetry.enable()\n"
        "pts = np.random.default_rng(0).uniform(0, 1, (300, 3)).astype(np.float32)\n"
        "srv = QueryServer(device='cpu')\n"
        "srv.create_index('default', Points(torch.from_numpy(pts)))\n"
        "rs = srv.handle([knn_request(pts[:5], k=2), within_request(pts[:5], 0.1),\n"
        "                 ray_request(pts[:5], np.ones((5, 3), np.float32))])\n"
        "assert rs[0].idxs[:, 0].tolist() == list(range(5))\n"
        "assert (rs[1].counts >= 1).all() and (rs[2].dists[:, 0] == 0).all()\n"
        "with ServingPipeline(device='cpu') as pipe:\n"
        "    pipe.create_index('default', Points(torch.from_numpy(pts)))\n"
        "    r = pipe.submit(knn_request(pts[:3], k=1)).result(60)\n"
        "    pipe.update_index('default', Points(torch.from_numpy(pts + 1e-3)))\n"
        "    assert pipe.wait_maintenance_idle(60)\n"
        "    assert pipe.stats().refits == 1\n"
        "assert r.idxs[:, 0].tolist() == [0, 1, 2]\n"
        "names = {s.name for s in telemetry.get_tracer().drain()}\n"
        "assert {'engine.kernel', 'store.refit', 'request'} <= names\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("REPRO_TELEMETRY", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_service_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from repro_torch.service import IndexStore, QueryServer, ServingPipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (IndexStore, QueryServer, ServingPipeline,
                 lambda: IndexStore(device=None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert IndexStore(device="cpu").device.type == "cpu"


def _serving_twins_raise(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    for mod, name in ((TT, "bvh_traverse_spatial_ref"),
                      (TT, "bvh_traverse_knn_ref"),
                      (TT, "bvh_traverse_ray_knn_ref"),
                      (TK, "karras_ranges_fused"), (TK, "lbvh_tail_ref"),
                      (TK, "lbvh_refit_ref"), (TK, "aabb_rmq"),
                      (TM, "morton_key_ref"), (M, "_interleave")):
        monkeypatch.setattr(mod, name, boom)


@pytest.mark.cuda
def test_server_on_the_card_launches_one_kernel_a_group(cuda_device,
                                                        monkeypatch):
    """Each group of a warm server on the card is one launch of its
    kernel (spatial, kNN, ray kNN) and never a twin; no cache miss and
    no library load after the warm-up."""
    from repro_torch.core.engine import EngineConfig, QueryEngine
    from repro_torch.core.route_table import RouteRule, RouteTable
    from repro_torch.kernels import _build
    from repro_torch.service import (QueryServer, ServiceConfig, knn_request,
                                     ray_request, within_request)
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    q = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    eng = QueryEngine(EngineConfig(route_table=RouteTable(
        rules={"default": RouteRule(bf_max_work=0)})))
    cpu = BVH(TG.Points(torch.from_numpy(pts)),
              policy=ExecutionPolicy(device="cpu", engine=eng))
    want = cpu.query(TP.nearest(TG.Points(torch.from_numpy(q)), k=4))
    _serving_twins_raise(monkeypatch)
    srv = QueryServer(engine=eng, config=ServiceConfig(capacity=16,
                                                       max_bucket=64))
    srv.create_index("pts", TG.Points(torch.from_numpy(pts)))
    srv.create_index("boxes", TG.Boxes(torch.from_numpy(pts),
                                       torch.from_numpy(pts + 0.01)))
    srv.warmup("pts", [("knn", 4), ("within", 0), ("ray", 2)])
    srv.warmup("boxes", [("knn", 4), ("within", 0), ("ray", 2)])
    before = eng.stats.snapshot()
    libs, funcs = len(_build._LIBS), len(_build._FUNCS)
    counters = (TT.bvh_traverse_spatial, TT.bvh_traverse_knn,
                TT.bvh_traverse_ray_knn)
    for f in counters:
        f.launches = 0
    rs = srv.handle([knn_request(q[:7], 4, "pts"), knn_request(q, 4, "pts"),
                     within_request(q, 0.05, "pts"),
                     ray_request(q, d, 2, "boxes")])
    assert [f.launches for f in counters] == [1, 1, 1]
    assert {r.stats.route for r in rs} == {"kernel"}
    assert all(r.stats.cache_hit for r in rs)
    after = eng.stats.snapshot()
    assert (after.cache_misses, after.jit_traces) == \
        (before.cache_misses, before.jit_traces)
    assert (len(_build._LIBS), len(_build._FUNCS)) == (libs, funcs)
    assert np.array_equal(rs[1].dists, want.distances.numpy())
    assert np.array_equal(rs[1].idxs, want.indices.numpy())


@pytest.mark.cuda
def test_refit_on_the_maintenance_stream_serves_correctly(cuda_device):
    """A refit on the pipeline's maintenance stream publishes a tree that
    a query on the serving stream reads correctly: the answers equal the
    CPU twins' over the moved points, version by version."""
    from repro_torch.core.engine import EngineConfig, QueryEngine
    from repro_torch.core.route_table import RouteRule, RouteTable
    from repro_torch.service import (PipelineConfig, ServiceConfig,
                                     ServingPipeline, knn_request)
    eng = QueryEngine(EngineConfig(route_table=RouteTable(
        rules={"default": RouteRule(bf_max_work=0)})))
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 1, (20000, 3)).astype(np.float32)
    q = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    cfg = PipelineConfig(service=ServiceConfig(capacity=16, max_bucket=64))
    with ServingPipeline(engine=eng, config=cfg) as pipe:
        assert pipe.maintenance_stream is not None
        pipe.create_index("pts", TG.Points(torch.from_numpy(pts)))
        moved = pts
        for step in range(5):
            moved = moved + rng.normal(0, 0.002, moved.shape).astype(np.float32)
            # made on the caller's stream, read on the maintenance stream
            values = TG.Points(torch.from_numpy(moved).to(cuda_device) * 1.0)
            pipe.update_index("pts", values)
            assert pipe.wait_maintenance_idle(60)
            r = pipe.submit(knn_request(q, 5, "pts")).result(60)
            assert r.stats.index_version == step + 2
            cpu = BVH(TG.Points(torch.from_numpy(moved)),
                      policy=ExecutionPolicy(device="cpu", engine=eng))
            want = cpu.query(TP.nearest(TG.Points(torch.from_numpy(q)), k=5))
            assert np.array_equal(r.dists, want.distances.numpy()), step
            assert np.array_equal(r.idxs, want.indices.numpy()), step
        st = pipe.stats()
    assert st.refits == 5 and st.maintenance_errors == 0
    assert st.stalled_behind_maintenance == 0


# ---------------------------------------------------------------------------
# the algorithms slice: Nearest.exclude, EMST, MLS
# ---------------------------------------------------------------------------

ALGORITHM_MODULES = tuple(importlib.import_module(f"repro_torch.core.{m}")
                          for m in ("emst", "interpolation"))


def test_algorithm_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in ALGORITHM_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


def test_algorithms_run_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch, repro_torch as rt\n"
        "x = np.random.default_rng(0).uniform(0, 1, (200, 3)).astype(np.float32)\n"
        "eu, ev, ew = rt.emst(x, device='cpu')\n"
        "assert eu.shape == (199,) and bool((eu >= 0).all())\n"
        "assert bool(torch.isfinite(ew).all())\n"
        "f = x @ np.array([1.5, -2.0, 0.25], np.float32) + 3.0\n"
        "v = rt.mls_interpolate(x, f, x[:20] * 0.5 + 0.25, degree=1, device='cpu')\n"
        "assert np.allclose(v.numpy(), (x[:20] * 0.5 + 0.25) @ [1.5, -2.0, 0.25] + 3.0,\n"
        "                   atol=1e-3)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_algorithms_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(1).uniform(0, 1, (20, 3)).astype(np.float32)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    from repro_torch import emst, mls_interpolate
    for call in (lambda: emst(x), lambda: mls_interpolate(x, x[:, 0], x[:4])):
        with pytest.raises(RuntimeError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_exclusion_wrapper_refuses_other_devices_and_counts_only_launches():
    t, x = _tree_args()
    meta = {f: getattr(t, f).to("meta") for f in TL.FIELDS}
    lab = torch.zeros((x.shape[0],), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        TT.bvh_traverse_knn_exclude(
            *(meta[f] for f in ("node_lo", "node_hi", "rope", "left_child",
                                "leaf_perm", "range_first", "range_last")),
            x[:4].to("meta"), lab[:4].to("meta"), lab.to("meta"), k=2)
    before = TT.bvh_traverse_knn_exclude.launches
    TT.bvh_traverse_knn_exclude(
        *(getattr(t, f) for f in ("node_lo", "node_hi", "rope", "left_child",
                                  "leaf_perm", "range_first", "range_last")),
        x[:4], lab[:4] + 1, lab, k=2)
    assert TT.bvh_traverse_knn_exclude.launches == before


@pytest.mark.cuda
def test_exclusion_on_the_card_never_calls_the_twin(cuda_device, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(TT, "bvh_traverse_knn_exclude_ref", boom)
    x = torch.rand((500, 3), device=cuda_device)
    lab = (torch.arange(500, device=cuda_device) % 7).to(torch.int32)
    res = BVH(TG.Points(x), policy=ExecutionPolicy(device=cuda_device)).query(
        TP.nearest(TG.Points(x), k=2, exclude=(lab, lab)))
    torch.cuda.synchronize()
    assert bool((lab[res.indices.clamp_min(0).long()] != lab[:, None]).all())


# ---------------------------------------------------------------------------
# the remaining geometries: Triangles, Segments, Tetrahedra and KDOPs
# ---------------------------------------------------------------------------

def test_geometry_paths_run_with_jax_blocked():
    """Intersects, Nearest and callbacks over Segments, Tetrahedra, KDOPs
    and Triangles values, the fine kNN walk's twin and the callback
    kernel's twin, with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch, repro_torch as rt\n"
        "from repro_torch.kernels import bvh_traverse as BT\n"
        "rng = np.random.default_rng(0)\n"
        "a = rng.uniform(0, 1, (300, 3)).astype(np.float32)\n"
        "e = lambda: torch.from_numpy((a + rng.uniform(-.1, .1, a.shape)).astype(np.float32))\n"
        "A = torch.from_numpy(a)\n"
        "dirs = rt.kdop_directions(3, 14)\n"
        "sup = torch.stack([A, e(), e()], 1) @ dirs.T\n"
        "values = [rt.Segments(A, e()), rt.Tetrahedra(A, e(), e(), e()),\n"
        "          rt.KDOPs(sup.amin(1), sup.amax(1), dirs), rt.Triangles(A, e(), e())]\n"
        "table = rt.RouteTable(rules={'default': rt.RouteRule(bf_max_work=0)})\n"
        "pol = rt.ExecutionPolicy(device='cpu', engine=rt.QueryEngine(rt.EngineConfig(route_table=table)))\n"
        "q = torch.from_numpy(rng.uniform(0, 1, (16, 3)).astype(np.float32))\n"
        "for v in values:\n"
        "    idx = rt.BVH(v, policy=pol)\n"
        "    bf = rt.BruteForce(v, policy=pol)\n"
        "    s = rt.Spheres(q, torch.full((16,), 0.1))\n"
        "    r = idx.query(rt.intersects(s))\n"
        "    c = idx.query(rt.intersects(s), callback=rt.callbacks.counting())\n"
        "    assert c.tolist() == r.offsets.diff().tolist()\n"
        "    calls = BT.bvh_traverse_fine_knn.launches\n"
        "    k = idx.query(rt.nearest(rt.Points(q), k=3))\n"
        "    kb = bf.query(rt.nearest(rt.Points(q), k=3))\n"
        "    assert k.indices.shape == (16, 3) and bool(torch.isfinite(k.distances).all())\n"
        "    assert torch.allclose(k.distances, kb.distances, rtol=1e-5, atol=1e-6)\n"
        "    assert BT.bvh_traverse_fine_knn.launches == calls\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fine_knn_wrapper_refuses_other_devices_and_counts_only_launches():
    t, x = _tree_args()
    segs = TG.Segments(x, x + 0.01)
    meta = {f: getattr(t, f).to("meta") for f in TL.FIELDS}
    with pytest.raises(ValueError, match="no kernel"):
        TT.bvh_traverse_fine_knn(
            *(meta[f] for f in ("node_lo", "node_hi", "rope", "left_child",
                                "leaf_perm")),
            segs.to("meta"), TG.Points(x[:4].to("meta")), k=2)
    tree = TL.build(TG.to_boxes(segs))
    before = TT.bvh_traverse_fine_knn.launches
    d, i = TT.bvh_traverse_fine_knn(
        *(getattr(tree, f) for f in ("node_lo", "node_hi", "rope",
                                     "left_child", "leaf_perm")),
        segs, TG.Points(x[:4]), k=2)
    assert TT.bvh_traverse_fine_knn.launches == before
    assert i[:, 0].tolist() == [0, 1, 2, 3] and bool((d[:, 0] == 0).all())
    with pytest.raises(ValueError, match="Spheres, Triangles"):
        TT.bvh_traverse_fine_knn(
            *(getattr(tree, f) for f in ("node_lo", "node_hi", "rope",
                                         "left_child", "leaf_perm")),
            TG.Points(x), TG.Points(x[:4]), k=2)


@pytest.mark.cuda
def test_geometry_paths_on_the_card_never_call_the_twins(cuda_device,
                                                         monkeypatch):
    """BVH.query over Tetrahedra and Triangles on the card: the callback
    kernel and the fine kNN kernel, never their twins nor the walks."""
    def boom(*a, **k):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(TT, "bvh_traverse_fine_knn_ref", boom)
    monkeypatch.setattr(TC, "bvh_traverse_callback_ref", boom)
    from repro_torch.core import traversal as TW
    monkeypatch.setattr(TW, "knn_walk", boom)
    monkeypatch.setattr(TW, "walk", boom)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.rand((2000, 3), generator=g, device=cuda_device)
    e = lambda: a + 0.05 * torch.rand((2000, 3), generator=g,  # noqa: E731
                                      device=cuda_device)
    q = torch.rand((256, 3), generator=g, device=cuda_device)
    from repro_torch import EngineConfig, QueryEngine, RouteRule, RouteTable
    table = RouteTable(rules={"default": RouteRule(bf_max_work=0)})
    pol = ExecutionPolicy(device=cuda_device,
                          engine=QueryEngine(EngineConfig(route_table=table)))
    for values in (TG.Tetrahedra(a, e(), e(), e()), TG.Triangles(a, e(), e())):
        index = BVH(values, policy=pol)
        res = index.query(TP.intersects(TG.Points(q)))
        knn = index.query(TP.nearest(TG.Points(q), k=4))
        torch.cuda.synchronize()
        assert res.offsets.shape == (257,)
        assert bool(torch.isfinite(knn.distances).all())


# ---------------------------------------------------------------------------
# distributed search: DistributedTree and the sharded serving stack
# ---------------------------------------------------------------------------

DISTRIBUTED_MODULES = tuple(importlib.import_module(f"repro_torch.{m}")
                            for m in ("core.comm", "core.distributed",
                                      "service.sharded"))


def test_distributed_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in DISTRIBUTED_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


def test_distributed_runs_with_jax_blocked():
    """A 2-rank gloo world: DistributedTree and a ShardedIndexStore behind
    a QueryServer answer with JAX and the JAX package blocked; on the CPU
    the default device raises on every rank, as on one process."""
    from test_torch_parity import run_world
    code = (
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch as rt\n"
        "from repro_torch.service import QueryServer, ShardedIndexStore, knn_request\n"
        "pts = np.random.default_rng(0).uniform(0, 1, (200, 3)).astype(np.float32)\n"
        "mine = pts[RANK * 100:(RANK + 1) * 100]\n"
        "pol = rt.ExecutionPolicy(device='cpu')\n"
        "dt = rt.DistributedTree(None, mine, policy=pol)\n"
        "res = dt.query(rt.nearest(rt.Points(torch.from_numpy(mine[:4])), k=1))\n"
        "assert (res.indices[:, 0] == torch.arange(4) + 100 * RANK).all()\n"
        "srv = QueryServer(store=ShardedIndexStore(None, device='cpu'))\n"
        "srv.create_index('default', mine)\n"
        "(r,) = srv.handle([knn_request(pts[[7, 150]], 1)])\n"
        "assert r.idxs[:, 0].tolist() == [7, 150] and r.stats.route == 'sharded'\n"
        "torch.cuda.is_available = lambda: False\n"
        "for make in (lambda: rt.DistributedTree(None, mine),\n"
        "             lambda: ShardedIndexStore(None)):\n"
        "    try:\n"
        "        make()\n"
        "        raise SystemExit('no raise')\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    outs = run_world(code, 2, timeout=120)
    assert [o.strip() for o in outs] == ["ok", "ok"]


def test_an_nccl_group_refuses_an_index_off_the_card(monkeypatch):
    from repro_torch.core import comm
    monkeypatch.setattr(comm, "is_nccl", lambda group: True)
    with pytest.raises(ValueError, match="NCCL"):
        comm.check_device(None, torch.device("cpu"))
    comm.check_device(None, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="NCCL"):
        comm._wire(None, torch.zeros(2))


def test_comm_tree_map_keeps_non_tensors_and_shared_directions():
    from repro_torch.core import comm
    dirs = TG.kdop_directions(3, 14)
    k = TG.KDOPs(torch.zeros((4, 7)), torch.ones((4, 7)), dirs)
    pred = TP.nearest(k, k=3, data={"w": torch.arange(4)})
    got = comm.tree_map(lambda t: t[:2], pred)
    assert got.k == 3 and got.geom.directions is dirs
    assert got.geom.lo.shape == (2, 7) and got.data["w"].tolist() == [0, 1]
    rows = torch.arange(12.0).reshape(3, 4)
    assert comm.fold(rows, torch.add).tolist() == rows.sum(0).tolist()
    assert comm.fold((rows, rows), lambda a, b: (a[0] - b[0], a[1] * b[1])
                     )[0].tolist() == (rows[0] - rows[1] - rows[2]).tolist()


# ---------------------------------------------------------------------------
# the port's static analysis (repro_torch.analysis)
# ---------------------------------------------------------------------------

ANALYSIS_MODULES = tuple(importlib.import_module(f"repro_torch.analysis.{m}")
                         for m in ("findings", "astutil", "locks",
                                   "telemetry_lint", "tracer", "launches",
                                   "smoke", "__main__"))


def test_analysis_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in ANALYSIS_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


def test_analysis_passes_import_the_standard_library_alone():
    """The passes work on the AST: at module level they import the
    standard library and each other, nothing else (torch and the kernels
    only inside the smoke and the strict pass, which run them)."""
    import sys as _sys
    std = set(_sys.stdlib_module_names) | {"__future__"}
    for mod in ANALYSIS_MODULES:
        tree = ast.parse(open(mod.__file__).read())
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert all(n.split(".")[0] in std for n in names), (mod, names)


def test_analysis_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch import analysis\n"
        "from repro_torch.analysis.__main__ import main\n"
        "assert main([]) == 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "reprolint (default): 0 finding(s), " \
        "0 suppressed"


# ---------------------------------------------------------------------------
# slice 18: the LM serving path of every family
# ---------------------------------------------------------------------------

SERVING_LM_MODULES = tuple(importlib.import_module(f"repro_torch.{m}")
                           for m in ("models.moe", "models.mamba2",
                                     "models.serve", "launch",
                                     "launch.serve"))


def test_lm_serving_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in SERVING_LM_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


def test_lm_serving_runs_with_jax_blocked():
    """Every family's LM, a cache, a prefill and decode steps, and the
    driver, with JAX and the reference blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch, repro_torch as rt\n"
        "from repro_torch.models import serve\n"
        "from repro_torch.launch.serve import main\n"
        "for arch in rt.configs.all_archs():\n"
        "    cfg = rt.get_config(arch, smoke=True)\n"
        "    m = rt.LM.from_config(cfg, seed=0, device='cpu')\n"
        "    c = serve.init_cache(cfg, 1, 6, torch.float32, enc_len=3,\n"
        "                         device='cpu')\n"
        "    with torch.inference_mode():\n"
        "        if cfg.family == 'encdec':\n"
        "            c = serve.prefill_encoder(m, c, torch.ones((1, 3, cfg.d_model)))\n"
        "        c, lg = serve.prefill(m, c, torch.zeros((1, 5), dtype=torch.long))\n"
        "    assert lg.shape == (1, 5, cfg.vocab) and int(c['index']) == 5\n"
        "    assert bool(torch.isfinite(lg).all()), arch\n"
        "out = main(['--smoke', '--arch', 'zamba2-7b', '--batch', '1',\n"
        "            '--prompt-len', '3', '--gen', '2', '--device', 'cpu'])\n"
        "assert out.shape == (1, 2)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_lm_serving_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """init_cache, launch.serve.main, LM.from_config of every family and
    convert.cache_from_numpy take the card when no device is given, and
    raise resolve_device's error without one."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    calls = [lambda: launch.main(["--smoke"]),
             lambda: convert.cache_from_numpy(
                 {"index": np.int32(0), "k": np.zeros((1, 1, 1, 1, 2),
                                                      np.float32)})]
    for arch in TCF.all_archs():
        cfg = get_config(arch, smoke=True)
        calls += [lambda cfg=cfg: serve.init_cache(cfg, 1, 4),
                  lambda cfg=cfg: LM.from_config(cfg)]
    for call in calls:
        with pytest.raises(RuntimeError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_lm_serving_files_lint_clean():
    """reprolint over the slice's files alone: no finding."""
    from repro_torch import analysis
    paths = [m.__file__ for m in SERVING_LM_MODULES] + [
        os.path.join(PORT, "models", f)
        for f in ("attention.py", "lm.py", "layers.py")] + [
        os.path.join(PORT, "convert.py")]
    assert analysis.analyze(paths) == []


@pytest.mark.cuda
def test_decode_step_on_the_card_makes_no_host_sync(cuda_device):
    """A dense decode step under sync-debug "error": any host sync (an
    .item(), a copy from the host) raises."""
    from repro_torch.models import serve
    cfg = dataclasses.replace(get_config(SMOKE, smoke=True), window=4)
    model = LM.from_config(cfg, seed=0)
    cache = serve.init_cache(cfg, 2, 8, torch.float32)
    tok = torch.zeros((2, 1), dtype=torch.long, device=cuda_device)
    with torch.inference_mode():
        serve.decode_step(model, cache, tok)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(6):                       # the ring wraps
                lg, cache = serve.decode_step(model, cache, tok)
                tok = lg[:, -1:].argmax(-1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert int(cache["index"]) == 7


# ---------------------------------------------------------------------------
# slice 19: the LM's training
# ---------------------------------------------------------------------------

TRAINING_MODULES = tuple(importlib.import_module(f"repro_torch.{m}")
                         for m in ("optim", "optim.adamw",
                                   "optim.compression", "train", "train.step",
                                   "train.straggler", "data", "data.pipeline",
                                   "checkpoint", "checkpoint.manager",
                                   "launch.train"))


def test_training_modules_are_scanned_for_imports():
    files = {os.path.realpath(p) for p in _port_files()}
    for mod in TRAINING_MODULES:
        assert os.path.realpath(mod.__file__) in files, mod


def test_training_runs_with_jax_blocked():
    """A train step of every family, a checkpoint written and restored,
    and the driver with a resume, with JAX and the reference blocked."""
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch, repro_torch as rt\n"
        "from repro_torch import convert\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch.data import synthetic_batch\n"
        "from repro_torch.launch.train import main\n"
        "from repro_torch.optim import adamw_init\n"
        "from repro_torch.train import make_train_step\n"
        "for arch in rt.configs.all_archs():\n"
        "    cfg = rt.get_config(arch, smoke=True)\n"
        "    m = rt.LM.from_config(cfg, seed=0, device='cpu')\n"
        "    b = synthetic_batch(0, 0, 2, 8, cfg.vocab, device='cpu')\n"
        "    if cfg.family == 'vlm':\n"
        "        b['patch_embeds'] = torch.ones((2, 2, cfg.d_model))\n"
        "    if cfg.family == 'encdec':\n"
        "        b['src_embeds'] = torch.ones((2, 3, cfg.d_model))\n"
        "    opt = adamw_init(m)\n"
        "    met = make_train_step(cfg, lr=1e-3, warmup=1)(m, opt, b)\n"
        "    assert bool(torch.isfinite(met['loss'])), arch\n"
        "d = tempfile.mkdtemp()\n"
        "mgr = CheckpointManager(d)\n"
        "mgr.save(1, {'params': convert.lm_to_numpy(m),\n"
        "             'opt': convert.opt_to_numpy(opt)})\n"
        "mgr.wait()\n"
        "step, tree, _ = mgr.restore()\n"
        "assert step == 1 and int(tree['opt']['step']) == 1\n"
        "args = ['--smoke', '--batch', '1', '--seq', '8', '--device', 'cpu',\n"
        "        '--ckpt-dir', tempfile.mkdtemp()]\n"
        "main(args + ['--steps', '2'])\n"
        "main(args + ['--steps', '3'])\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "resumed from step 2" in lines and lines[-1] == "ok"


def test_training_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """launch.train.main, TokenPipeline and synthetic_batch take the card
    when no device is given, and raise resolve_device's error without
    one."""
    from repro_torch.data import TokenPipeline, synthetic_batch
    from repro_torch.launch import train as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    for call in (lambda: launch.main(["--smoke", "--steps", "1"]),
                 lambda: TokenPipeline(0, 1, 2, 3),
                 lambda: synthetic_batch(0, 0, 1, 2, 3)):
        with pytest.raises(RuntimeError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_training_files_lint_clean():
    """reprolint over the slice's files alone: no finding."""
    from repro_torch import analysis
    assert analysis.analyze([m.__file__ for m in TRAINING_MODULES]) == []


@pytest.mark.cuda
def test_train_step_on_the_card_adds_no_host_sync(cuda_device):
    """Under sync-debug "warn", no host sync of a dense train step comes
    from the step's, the optimizer's or the schedule's own code (each
    warning names the Python line that made it)."""
    import warnings
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.data import synthetic_batch
    cfg = dataclasses.replace(get_config(SMOKE, smoke=True), remat=True)
    model = LM.from_config(cfg, seed=0)
    opt = adamw_init(model)
    step = make_train_step(cfg, lr=1e-3, warmup=2)
    batch = synthetic_batch(0, 0, 2, 16, cfg.vocab)
    step(model, opt, batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(model, opt, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    own = [f"{w.filename}:{w.lineno}" for w in seen
           if "called a synchronizing CUDA operation" in str(w.message)
           and re.search(r"repro_torch[/\\](train|optim)[/\\]",
                         w.filename)]
    assert own == []
    assert int(opt["step"]) == 2
