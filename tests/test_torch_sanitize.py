"""REPRO_SANITIZE in the port (``repro_torch.kernels.sanitize``): each
output-contract check raises on a crafted bad output when armed and stays
silent unarmed; each kernel wrapper runs its check on what it returns;
an armed run of the port's CPU paths passes."""
import importlib

import pytest
import torch

from test_torch_parity import one_torch_thread  # noqa: F401 (fixture)
from repro_torch import (BVH, EngineConfig, ExecutionPolicy, QueryEngine,
                         callbacks, intersects, nearest)
from repro_torch.core import callbacks as CB
from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import morton as M
from repro_torch.core import predicates as TP
from repro_torch.core.index import _bcast_state
from repro_torch.kernels import bvh_callback as TC
from repro_torch.kernels import bvh_traverse as TT
from repro_torch.kernels import lbvh_build as TK
from repro_torch.kernels import ops as TO
from repro_torch.kernels import sanitize as S

TB = importlib.import_module("repro_torch.kernels.bruteforce_knn")
NAN = float("nan")


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")


def _good_karras(n=9):
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    codes, _ = M.sort_by_morton(M.morton64(x, x.amin(0), x.amax(0)),
                                torch.arange(n))
    hi, lo, idx = M.combined_delta_key(codes, n)
    return TK.karras_ranges_fused(hi, lo, idx, n, 4)


def _bad_outputs():
    """(label, check) pairs: each call violates its contract."""
    cnt = torch.tensor([1, 2, 0], dtype=torch.int32)
    buf = torch.tensor([[0, -1], [3, 1], [-1, -1]], dtype=torch.int32)
    d = torch.tensor([[0.1, 0.2], [0.3, 0.4]])
    i = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    first, last, gamma = _good_karras()
    yield "negative count", lambda: S.check_spatial(
        torch.tensor([1, -1, 0], dtype=torch.int32), buf, n=4, kernel="k")
    yield "count above n", lambda: S.check_spatial(
        torch.tensor([1, 5, 0], dtype=torch.int32), buf, n=4, kernel="k")
    yield "spatial index >= n", lambda: S.check_spatial(
        cnt, torch.tensor([[0, 4]], dtype=torch.int32), n=4, kernel="k")
    yield "knn index >= n", lambda: S.check_knn(
        d, torch.tensor([[0, 1], [2, 4]], dtype=torch.int32), n=4, kernel="k")
    yield "knn index < -1", lambda: S.check_knn(
        d, torch.tensor([[0, -2], [2, 3]], dtype=torch.int32), n=4, kernel="k")
    yield "descending", lambda: S.check_knn(
        torch.tensor([[0.2, 0.1], [0.3, 0.4]]), i, n=4, kernel="k")
    yield "NaN distance", lambda: S.check_knn(
        torch.tensor([[0.1, NAN], [0.3, 0.4]]), i, n=4, kernel="k")
    bad_last = last.clone()
    bad_last[2] = 1                      # node 2's range ends before it
    yield "karras range outside its node", lambda: S.check_karras(
        first, bad_last, gamma, n=9, kernel="k")
    bad_gamma = gamma.clone()
    bad_gamma[0] = last[0]               # the split must lie before last
    yield "karras split at last", lambda: S.check_karras(
        first, last, bad_gamma, n=9, kernel="k")
    yield "NaN state leaf", lambda: S.check_state_tree(
        (torch.zeros(3, dtype=torch.int32), torch.tensor([0.0, NAN, 1.0])),
        kernel="k")


BAD = list(_bad_outputs())


@pytest.mark.parametrize("label,call", BAD, ids=[b[0] for b in BAD])
def test_each_check_raises_when_armed(armed, label, call):
    with pytest.raises(AssertionError, match="REPRO_SANITIZE"):
        call()


@pytest.mark.parametrize("value", ["", "0", "false"])
def test_checks_are_silent_unarmed(monkeypatch, value):
    monkeypatch.setenv("REPRO_SANITIZE", value)
    assert not S.enabled()
    for _, call in BAD:
        call()
    monkeypatch.delenv("REPRO_SANITIZE")
    for _, call in BAD:
        call()


def test_good_outputs_pass_when_armed(armed):
    first, last, gamma = _good_karras()
    S.check_karras(first, last, gamma, n=9, kernel="k")
    S.check_knn(torch.tensor([[0.1, float("inf")]]),
                torch.tensor([[3, -1]], dtype=torch.int32), n=4, kernel="k")
    S.check_spatial(torch.tensor([0, 4], dtype=torch.int32),
                    torch.tensor([[-1], [3]], dtype=torch.int32), n=4,
                    kernel="k")
    S.check_state_tree((torch.zeros(2), torch.ones(1)), kernel="k")
    S.check_state_tree(torch.full((2,), float("inf")), kernel="k")


def _tree(n=40):
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    return TL.build(TG.Boxes(x, x)), x


def test_wrappers_check_their_outputs(armed, monkeypatch):
    """A twin that breaks its contract is caught by the wrapper."""
    t, x = _tree()
    q = x[:4]

    def descending(*a, **k):
        return (torch.tensor([[0.2, 0.1]] * 4),
                torch.zeros((4, 2), dtype=torch.int32))

    monkeypatch.setattr(TT, "bvh_traverse_knn_ref", descending)
    with pytest.raises(AssertionError, match="bvh_traverse_knn"):
        TT.bvh_traverse_knn(t.node_lo, t.node_hi, t.rope, t.left_child,
                            t.leaf_perm, q, k=2)
    monkeypatch.setattr(TT, "bvh_traverse_spatial_ref", lambda *a, **k: (
        torch.full((4,), -1, dtype=torch.int32),
        torch.zeros((4, 1), dtype=torch.int32)))
    with pytest.raises(AssertionError, match="bvh_traverse_spatial"):
        TT.bvh_traverse_spatial(t.node_lo, t.node_hi, t.rope, t.left_child,
                                t.range_last, t.leaf_perm, q, q,
                                torch.zeros(4))
    monkeypatch.setattr(TC, "bvh_traverse_callback_ref",
                        lambda *a, **k: torch.full((4,), NAN))
    cb, s0 = CB.min_distance()
    with pytest.raises(AssertionError, match="bvh_traverse_callback"):
        TC.bvh_traverse_callback(t.node_lo, t.node_hi, t.rope, t.left_child,
                                 t.range_last, t.leaf_perm, TG.Points(x),
                                 TP.intersects(TG.Points(q)), cb,
                                 _bcast_state(s0, 4, "cpu"))
    monkeypatch.setattr(TB, "bruteforce_knn_ref", descending)
    with pytest.raises(AssertionError, match="bruteforce_knn"):
        TO.bruteforce_knn(q, x, 2)
    first, last, gamma = _good_karras()
    monkeypatch.setattr(TK, "karras_ranges_fused",
                        lambda *a: (first, last, last.clone()))
    with pytest.raises(AssertionError, match="karras"):
        TK.karras_ranges(*(torch.zeros(9, dtype=torch.int64),) * 3, 9, 4)


def test_armed_cpu_paths_pass(armed, monkeypatch):
    """BVH build (Karras ranges), CSR and kNN queries and a callback query
    on the kernel route, and ops.bruteforce_knn, all with the checks on;
    every check runs."""
    ran = {}
    for name in ("check_spatial", "check_knn", "check_karras",
                 "check_state_tree"):
        def counted(*a, _f=getattr(S, name), _n=name, **k):
            ran[_n] = ran.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(S, name, counted)
    g = torch.Generator().manual_seed(2)
    x = torch.rand((300, 3), generator=g)
    qc = torch.rand((50, 3), generator=g)
    engine = QueryEngine(EngineConfig(force="kernel"))
    index = BVH(TG.Points(x), policy=ExecutionPolicy(device="cpu",
                                                     engine=engine))
    res = index.query(intersects(TG.Spheres(qc, torch.full((50,), 0.1))))
    assert int(res.offsets[-1]) > 0
    knn = index.query(nearest(TG.Points(qc), k=5))
    c = index.query(intersects(TG.Spheres(qc, torch.full((50,), 0.1))),
                    callback=callbacks.min_distance())
    assert torch.isfinite(c).any()
    d, i = TO.bruteforce_knn(qc, x, 5)
    assert torch.equal(i, knn.indices) or torch.allclose(d, knn.distances)
    d, i = TO.bruteforce_knn(qc, x[:3], 5)              # the k > N tail
    assert (i[:, 3:] == -1).all()
    assert set(ran) == {"check_spatial", "check_knn", "check_karras",
                        "check_state_tree"}, ran
    assert engine.callback_batches["kernel"] == 1
