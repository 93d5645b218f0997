"""PyTorch port vs the JAX package: the LBVH build engines.

Every (engine, refit) pair of ``core.lbvh.build`` ("pallas": the CUDA
build's kernels, their twins on the CPU; "ref": the plain PyTorch
pipeline; refit "rmq" or "iterative") gives every LBVH field equal, bit
for bit and NaN by place, to ``repro.core.lbvh.build`` with the same
arguments; so do ``BVH(build_engine=)``, ``ExecutionPolicy.build_engine``
and ``IndexStore(build_engine=)``, which pass the choice on.
``REPRO_ENGINE_FORCE`` beats the explicit engine, as in the reference
(its "kernel", or the reference's "pallas", forces "pallas"; "loop"
forces "ref").
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_build_path import boxes, same_tree
from repro.core import geometry as JG
from repro.core import lbvh as JL
from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import route_table as TRT
from repro_torch.core.bvh import BVH
from repro_torch.core.index import ExecutionPolicy
from repro_torch.service.index_store import IndexStore

PAIRS = [(e, r) for e in ("pallas", "ref") for r in ("rmq", "iterative")]
SCENES = [(100, 3, "points", 64), (65, 3, "nan", 32)]


@pytest.fixture(autouse=True)
def no_ambient_table(monkeypatch):
    """No persisted table and no force: the explicit engine decides."""
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", "off")
    monkeypatch.delenv("REPRO_ENGINE_FORCE", raising=False)
    TRT._reset_cache()
    yield
    TRT._reset_cache()


_REF = {}


def ref_tree(n, dim, kind, bits, engine, refit):
    key = (n, dim, kind, bits, engine, refit)
    if key not in _REF:
        lo, hi = boxes(n, dim, kind, seed=n)
        t = JL.build(JG.Boxes(jnp.asarray(lo), jnp.asarray(hi)), bits=bits,
                     refit=refit, engine=engine)
        _REF[key] = TL.LBVH(*(torch.from_numpy(np.array(getattr(t, f)))
                              for f in TL.FIELDS))
    return _REF[key]


def port_boxes(n, dim, kind):
    lo, hi = boxes(n, dim, kind, seed=n)
    return TG.Boxes(torch.from_numpy(lo), torch.from_numpy(hi))


@pytest.mark.parametrize("engine,refit", PAIRS)
@pytest.mark.parametrize("n,dim,kind,bits", SCENES)
def test_build_engines_match_reference(n, dim, kind, bits, engine, refit,
                                       monkeypatch):
    """lbvh.build(engine=, refit=) against the reference's build with the
    same arguments; the "ref" engine runs the plain pipeline (and only
    it), the "pallas" engine the kernels' wrappers."""
    ran = []
    real = TL._build_ref
    monkeypatch.setattr(TL, "_build_ref",
                        lambda *a: ran.append(1) or real(*a))
    got = TL.build(port_boxes(n, dim, kind), bits=bits, refit=refit,
                   engine=engine)
    same_tree(got, ref_tree(n, dim, kind, bits, engine, refit))
    assert len(ran) == (engine == "ref")


@pytest.mark.parametrize("engine,refit", PAIRS)
def test_entry_points_pass_the_build_engine_on(engine, refit, monkeypatch):
    """BVH(build_engine=, refit=), ExecutionPolicy(build_engine=) and
    IndexStore(build_engine=) build with the engine asked for."""
    n, dim, kind, _ = SCENES[0]
    ran = []
    real = TL._build_ref
    monkeypatch.setattr(TL, "_build_ref",
                        lambda *a: ran.append(1) or real(*a))
    lo, _ = boxes(n, dim, kind, seed=n)      # "points": hi is lo
    pts = TG.Points(torch.from_numpy(lo))
    jwant = ref_tree(*SCENES[0], engine, refit)
    a = BVH(pts, build_engine=engine, refit=refit,
            policy=ExecutionPolicy(device="cpu"))
    assert a.policy.build_engine == engine
    b = BVH(pts, refit=refit, policy=ExecutionPolicy(device="cpu",
                                                     build_engine=engine))
    c = IndexStore(build_engine=engine, device="cpu").build("p", pts).bvh
    assert c.policy.build_engine == engine
    for t in (a.tree, b.tree):
        same_tree(t, jwant)
    # the store builds with refit="rmq": the same floats for either refit
    same_tree(c.tree, jwant)
    assert len(ran) == 3 * (engine == "ref")


def test_refit_refuses_other_values():
    with pytest.raises(ValueError, match="refit"):
        TL.build(port_boxes(10, 3, "uniform"), refit="fixpoint")
    with pytest.raises(ValueError, match="engine"):
        TL.build(port_boxes(10, 3, "uniform"), engine="fused")


def test_build_engine_env_force_wins(monkeypatch):
    """REPRO_ENGINE_FORCE beats the explicit engine (the counterpart of
    the reference's test_build_engine_env_force_wins)."""
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "loop")
    assert TL._resolve_build_engine("pallas") == "ref"
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "kernel")
    assert TL._resolve_build_engine("ref") == "pallas"
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "pallas")    # the reference's
    assert TL._resolve_build_engine("ref") == "pallas"
    monkeypatch.delenv("REPRO_ENGINE_FORCE")
    assert TL._resolve_build_engine("ref") == "ref"
    assert TL._resolve_build_engine("auto") == "pallas"


def test_ambient_table_names_the_build_engine(monkeypatch, tmp_path):
    """"auto" takes the persisted table's build_engine (a table of this
    machine), after the explicit argument and the force."""
    path = tmp_path / "t.json"
    TRT.RouteTable(rules={"default": TRT.RouteRule()}, build_engine="ref",
                   fingerprint=TRT.hardware_fingerprint()).save(str(path))
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", str(path))
    TRT._reset_cache()
    assert TL._resolve_build_engine("auto") == "ref"
    assert TL._resolve_build_engine("pallas") == "pallas"
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "kernel")
    assert TL._resolve_build_engine("auto") == "pallas"
