"""PyTorch port vs the JAX package: the engine's route tables.

* the schema: ``validate_route_table`` accepts and rejects the same dicts
  as the reference's (its problems word for word), the repo's
  ``ROUTE_TABLE.json`` among them; ``to_dict`` / ``from_dict`` / ``save``
  / ``load`` round trips, ``single``'s TypeError;
* the fingerprint gate: a table the reference measured (a "jax" key) is
  ignored with a RuntimeWarning, a port table with this host's
  fingerprint is applied, ``$REPRO_TORCH_ROUTE_TABLE=off`` turns the
  ambient table off, and a rewritten table is read again (its mtime,
  after ``RECHECK_S``);
* the lookup order: the policy's table, the engine config's (a table or
  a path), ``REPRO_ENGINE_FORCE``, the ambient table, the defaults;
* the deprecated crossover fields: warn-once shims that make a one-rule
  table (the counterpart of ``test_api_surface.py``'s);
* the defaults route a grid of (op, value kind, N, Q, k) exactly as the
  port routed before it read tables (the oracle below transcribes that
  ``_pick``);
* the reference's adversarial tables (``test_build_conformance.py``)
  through the port's BVH against the reference's BVH under the same
  tables: counts and callback states bit for bit, CSR sets equal, kNN
  distances within 1e-5 (the reference's own bound across its routes);
* the tuner's derivation on synthetic measurements, and ``--validate``'s
  exit codes.
"""
import json
import os
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import callbacks as JCB
from repro.core import geometry as JG
from repro.core import predicates as JP
from repro.core import route_table as JRT
from repro.core.bvh import BVH as JBVH
from repro.core.index import ExecutionPolicy as JPolicy
from repro_torch.core import callbacks as TCB
from repro_torch.core import engine as TE
from repro_torch.core import geometry as TG
from repro_torch.core import index as TIX
from repro_torch.core import predicates as TP
from repro_torch.core import route_table as TRT
from repro_torch.core.bvh import BVH
from repro_torch.core.index import ExecutionPolicy
from repro_torch.kernels.bvh_callback import expressible
from repro_torch.kernels.bvh_traverse import KNN_MAX_K
from repro_torch.launch import autotune as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ExecutionPolicy(device="cpu")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No ambient table and no force unless a test sets one."""
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", "off")
    monkeypatch.delenv("REPRO_ENGINE_FORCE", raising=False)
    TRT._reset_cache()
    yield
    TRT._reset_cache()


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------

def _valid():
    return {"schema_version": 1, "build_engine": "pallas",
            "fingerprint": {"torch": "x"},
            "rules": {"default": {"bf_max_work": 5, "block_q": 128},
                      "knn": {"pallas_max_capacity": 7}}}


def _with(**kw):
    d = _valid()
    d.update(kw)
    return d


def _rule(**row):
    return _with(rules={"default": row})


SCHEMA_CASES = {
    "valid": _valid(),
    "repo_route_table": None,                  # ROUTE_TABLE.json
    "not_a_dict": [1, 2],
    "no_version": {k: v for k, v in _valid().items()
                   if k != "schema_version"},
    "version_2": _with(schema_version=2),
    "version_str": _with(schema_version="1"),
    "no_rules": {k: v for k, v in _valid().items() if k != "rules"},
    "empty_rules": _with(rules={}),
    "rules_list": _with(rules=[1]),
    "unknown_op": _with(rules={"fill": {"bf_max_work": 1}}),
    "row_not_dict": _with(rules={"default": 3}),
    "unknown_field": _rule(vmem_bytes=1),
    "negative": _rule(bf_max_work=-1),
    "float": _rule(bf_max_work=1.5),
    "bool": _rule(block_q=True),
    "string": _rule(pallas_max_nodes="big"),
    "block_not_pow2": _rule(block_q=96),
    "block_zero": _rule(block_q=0),
    "big_int": _rule(pallas_max_nodes=TRT.UNCAPPED),
    "bad_engine": _with(build_engine="fused"),
    "auto_engine": _with(build_engine="auto"),
    "no_engine": {k: v for k, v in _valid().items() if k != "build_engine"},
    "several_problems": _with(schema_version=0, build_engine="x",
                              rules={"default": {"block_q": 3,
                                                 "zz": 1}}),
}


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_validators_agree(case):
    d = SCHEMA_CASES[case]
    if d is None:
        with open(os.path.join(ROOT, "ROUTE_TABLE.json")) as f:
            d = json.load(f)
    want = JRT.validate_route_table(d)
    assert TRT.validate_route_table(d) == want
    if case in ("valid", "repo_route_table", "big_int", "auto_engine",
                "no_engine", "block_zero"):
        assert want == []
    else:
        assert want


def test_round_trips(tmp_path):
    t = TRT.RouteTable(
        rules={"default": TRT.RouteRule(bf_max_work=3),
               "knn": TRT.RouteRule(block_q=512, pallas_max_capacity=9)},
        fingerprint=TRT.hardware_fingerprint(), build_engine="ref",
        source="autotuned", measurements={"build": {"n": 4}})
    d = t.to_dict()
    back = TRT.RouteTable.from_dict(json.loads(json.dumps(d)))
    assert back.rules == t.rules and back.fingerprint == t.fingerprint
    assert back.build_engine == "ref" and back.measurements == t.measurements
    path = str(tmp_path / "t.json")
    t.save(path)
    loaded = TRT.RouteTable.load(path)
    assert loaded.to_dict() == d and loaded.source == path
    assert loaded.rule("spatial") == t.rules["default"]
    assert loaded.rule("knn").block_q == 512
    # the reference loads the port's file (its schema), and back
    jt = JRT.RouteTable.load(path)
    assert TRT.RouteTable.from_dict(jt.to_dict()).rules == t.rules
    with pytest.raises(TypeError, match="unknown RouteRule fields"):
        TRT.RouteTable.single(vmem=1)
    with pytest.raises(ValueError, match="invalid RouteTable"):
        TRT.RouteTable.from_dict(_rule(block_q=3))
    one = TRT.RouteTable.single(bf_max_work=0, build_engine="ref")
    assert one.rule("callback").bf_max_work == 0
    assert one.source == "synthesized" and one.build_engine == "ref"


# ---------------------------------------------------------------------------
# the fingerprint gate and the ambient table
# ---------------------------------------------------------------------------

def test_fingerprint_names_this_process():
    fp = TRT.hardware_fingerprint()
    assert fp["torch"] == torch.__version__
    assert fp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    if fp["backend"] == "cpu":
        assert fp["device_kind"] == "cpu" and fp["device_count"] == 1
    assert fp["cpu_count"] >= 1 and "jax" not in fp


def test_the_reference_table_is_never_applied(monkeypatch):
    """ROUTE_TABLE.json (measured by the reference on a CPU) is ignored
    with a RuntimeWarning, on this CPU too; so is a copy with this host's
    backend and device but the reference's framework."""
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE",
                       os.path.join(ROOT, "ROUTE_TABLE.json"))
    with pytest.warns(RuntimeWarning, match="ignoring persisted route"):
        assert TRT.default_route_table() is None
    fp = dict(TRT.hardware_fingerprint(), jax="0.4.37")
    del fp["torch"]
    assert not TRT._fingerprints_compatible(fp, TRT.hardware_fingerprint())
    assert not TRT._fingerprints_compatible({}, {})


def test_a_table_of_this_host_is_applied_and_reread(monkeypatch, tmp_path):
    path = tmp_path / "mine.json"
    fp = TRT.hardware_fingerprint()
    TRT.RouteTable(rules={"default": TRT.RouteRule(bf_max_work=77)},
                   fingerprint=fp).save(str(path))
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", str(path))
    t = TRT.default_route_table()
    assert t.rule("knn").bf_max_work == 77
    assert TRT.default_route_table() is t             # cached
    TRT.RouteTable(rules={"default": TRT.RouteRule(bf_max_work=78)},
                   fingerprint=fp).save(str(path))
    later = time.time() + 5
    os.utime(path, (later, later))
    # looked at again only after RECHECK_S seconds
    assert TRT.default_route_table() is t
    clock = TRT._clock
    monkeypatch.setattr(TRT, "_clock",
                        lambda: clock() + 2 * TRT.RECHECK_S)
    assert TRT.default_route_table().rule("knn").bf_max_work == 78
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", "off")
    assert TRT.default_route_table() is None
    # another device kind: ignored with a warning
    TRT.RouteTable(rules={"default": TRT.RouteRule()},
                   fingerprint=dict(fp, backend="cuda",
                                    device_kind="NVIDIA H100 80GB HBM3")
                   ).save(str(path))
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", str(path))
    TRT._reset_cache()
    if fp["backend"] == "cpu":
        with pytest.warns(RuntimeWarning):
            assert TRT.default_route_table() is None


def test_default_path_reads_the_port_file_at_the_root_or_cwd(monkeypatch,
                                                            tmp_path):
    monkeypatch.delenv("REPRO_TORCH_ROUTE_TABLE")
    monkeypatch.chdir(tmp_path)
    root_file = os.path.join(ROOT, "ROUTE_TABLE_TORCH.json")
    if not os.path.exists(root_file):
        assert TRT._default_path() is None
    (tmp_path / "ROUTE_TABLE_TORCH.json").write_text("{}")
    (tmp_path / "ROUTE_TABLE.json").write_text("{}")
    want = root_file if os.path.exists(root_file) else \
        str(tmp_path / "ROUTE_TABLE_TORCH.json")
    assert os.path.samefile(TRT._default_path(), want)


# ---------------------------------------------------------------------------
# the lookup order and the shims
# ---------------------------------------------------------------------------

def _points(n, seed, dim=3):
    return np.random.default_rng(seed).uniform(0, 1, (n, dim)).astype(
        np.float32)


def _tpts(a):
    return TG.Points(torch.from_numpy(a))


def test_lookup_order(monkeypatch, tmp_path):
    """policy table > engine-config table (a table or a path) > the force
    > the ambient table > the defaults; the force beats every table."""
    index = BVH(_tpts(_points(300, 1)), policy=CPU)
    preds = TP.intersects(_tpts(_points(20, 2)))     # N Q = 6000
    bf = TRT.RouteTable.single(bf_max_work=1 << 30)
    kernel = TRT.RouteTable.single(bf_max_work=0)
    loop = TRT.RouteTable.single(bf_max_work=0, pallas_min_queries=1 << 30)
    path = tmp_path / "loop.json"
    TRT.RouteTable(rules=loop.rules,
                   fingerprint=TRT.hardware_fingerprint()).save(str(path))
    eng = TE.QueryEngine()
    assert eng.route_spatial(index, preds) == TE.ROUTE_BRUTEFORCE
    monkeypatch.setenv("REPRO_TORCH_ROUTE_TABLE", str(path))
    assert eng.route_spatial(index, preds) == TE.ROUTE_LOOP        # ambient
    cfg_eng = TE.QueryEngine(TE.EngineConfig(route_table=str(path)))
    assert cfg_eng.config.route_table.rule("spatial") == loop.rule("x")
    cfg_eng = TE.QueryEngine(TE.EngineConfig(route_table=kernel))
    assert cfg_eng.route_spatial(index, preds) == TE.ROUTE_KERNEL  # config
    pol = CPU.override(route_table=bf)
    assert cfg_eng.route_spatial(index, preds, policy=pol) == \
        TE.ROUTE_BRUTEFORCE                                       # policy
    assert ExecutionPolicy(route_table=str(path)).route_table.rules == \
        loop.rules
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "loop")
    forced = TE.QueryEngine(TE.EngineConfig(route_table=kernel))
    assert forced.config.force == "loop"
    assert forced.route_spatial(index, preds, policy=pol) == TE.ROUTE_LOOP
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "pallas")   # the reference's
    assert TE.EngineConfig().force == "kernel"
    monkeypatch.setenv("REPRO_ENGINE_FORCE", "fused")
    with pytest.raises(ValueError, match="REPRO_ENGINE_FORCE"):
        TE.EngineConfig()
    monkeypatch.delenv("REPRO_ENGINE_FORCE")
    assert TE.EngineConfig(force="kernel").force == "kernel"


def test_use_kernels_and_max_executables():
    index = BVH(_tpts(_points(300, 1)), policy=CPU)
    big = TP.intersects(_tpts(_points(20000, 2)))
    off = TE.QueryEngine(TE.EngineConfig(use_kernels=False))
    assert TE.QueryEngine().route_spatial(index, big) == TE.ROUTE_KERNEL
    assert off.route_spatial(index, big) == TE.ROUTE_LOOP
    cb, _ = TCB.counting()
    assert off.route_callback(index, big, cb) == TE.ROUTE_LOOP
    assert TE.EngineConfig().max_executables == 256


def test_crossover_fields_warn_once():
    TIX._SEEN_DEPRECATIONS.discard("EngineConfig.crossovers")
    with pytest.warns(DeprecationWarning, match="RouteTable"):
        cfg = TE.EngineConfig(brute_force_max_work=123, pallas_min_queries=7)
    rule = cfg.route_table.rule("default")
    assert cfg.route_table.source == "synthesized"
    assert rule.bf_max_work == 123 and rule.pallas_min_queries == 7
    assert rule.pallas_min_leaves == TRT.RouteRule().pallas_min_leaves
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = TE.EngineConfig(pallas_max_nodes=5,
                                route_table=TRT.RouteTable.single(
                                    bf_max_work=9))
    assert again.route_table.rule("knn").bf_max_work == 9
    assert again.route_table.rule("knn").pallas_max_nodes == 5


# ---------------------------------------------------------------------------
# the defaults route as before
# ---------------------------------------------------------------------------

BF_MAX_WORK = 1 << 22


def _oracle_spatial(index, preds):
    """The port's route_spatial before it read tables: brute force for an
    Intersects batch while N Q <= 2^22, else the kernel where it can take
    the batch, else the loop."""
    n, q = index.size(), len(preds)
    bf_ok = isinstance(preds, TP.Intersects)
    k_ok = (index.tree is not None and q > 0 and index.kernel_values_ok
            and isinstance(preds, TP.Intersects)
            and isinstance(preds.geom, (TG.Points, TG.Boxes, TG.Spheres)))
    if bf_ok and n * q <= BF_MAX_WORK:
        return "bruteforce"
    return "kernel" if k_ok else "loop"


def _oracle_knn(index, preds):
    n, q = index.size(), len(preds)
    values_ok = index.kernel_values_ok or isinstance(
        index.values, (TG.Spheres, TG.Triangles))
    k_ok = (index.tree is not None and q > 0 and values_ok
            and preds.k <= KNN_MAX_K)
    if n * q <= BF_MAX_WORK:
        return "bruteforce"
    return "kernel" if k_ok else "loop"


def _oracle_callback(index, preds, cb):
    return "kernel" if (index.tree is not None and len(preds) > 0
                        and index.kernel_callback_ok
                        and expressible(index.values, preds, cb)) \
        else "loop"


VALUE_KINDS = ("points", "boxes", "spheres", "triangles")


def _values(kind, n):
    a = torch.from_numpy(_points(n, 5))
    if kind == "points":
        return TG.Points(a)
    if kind == "boxes":
        return TG.Boxes(a, a + 0.01)
    if kind == "spheres":
        return TG.Spheres(a, torch.full((n,), 0.01))
    return TG.Triangles(a, a + 0.01, a + torch.tensor([0.0, 0.01, 0.0]))


@pytest.mark.parametrize("kind", VALUE_KINDS)
def test_defaults_route_as_before(kind):
    """A grid of N, Q and k (brute force's crossover on both sides, Q = 0,
    N < 2, k past KNN_MAX_K) for each op over each value kind."""
    eng = TE.QueryEngine()
    cb, _ = TCB.counting()
    for n in (0, 1, 2, 300, 5000):
        index = BVH(_values(kind, n), policy=CPU)
        for q in (0, 1, 64, 1000):
            qp = _tpts(_points(q, 6))
            for preds in (TP.intersects(qp),
                          TP.intersects(TG.Spheres(qp.coords,
                                                   torch.full((q,), 0.1)))):
                if index.tree is not None:
                    assert eng.route_spatial(index, preds) == \
                        _oracle_spatial(index, preds), (kind, n, q)
                    assert eng.route_spatial(index, preds, 16) == \
                        _oracle_spatial(index, preds)
                    assert eng.route_callback(index, preds, cb) == \
                        _oracle_callback(index, preds, cb)
            if index.tree is None:
                continue
            for k in (1, 10, KNN_MAX_K + 1):
                preds = TP.nearest(qp, k)
                assert eng.route_knn(index, preds) == \
                    _oracle_knn(index, preds), (kind, n, q, k)


# ---------------------------------------------------------------------------
# adversarial tables: routes change, results do not
# ---------------------------------------------------------------------------

def _adversarial():
    return [
        JRT.RouteTable.single(),
        JRT.RouteTable.single(bf_max_work=1 << 40),
        JRT.RouteTable.single(bf_max_work=0, pallas_min_queries=1,
                              pallas_min_leaves=1, pallas_max_nodes=1 << 30,
                              block_q=8),
        JRT.RouteTable.single(bf_max_work=0, pallas_min_queries=1 << 30),
        JRT.RouteTable.single(pallas_max_nodes=1),
        JRT.RouteTable.single(bf_max_work=0, pallas_max_capacity=0),
    ]


@pytest.fixture(scope="module")
def reference_results():
    """The reference's count, CSR, kNN distances and callback states for
    the scene under each adversarial table (its test's scene)."""
    vals = _points(400, 7)
    qp = _points(32, 8)
    jp = JP.intersects(JG.Spheres(jnp.asarray(qp),
                                  jnp.full((32,), 0.25, jnp.float32)))
    jk = JP.nearest(JG.Points(jnp.asarray(qp)), k=4)
    cb, s0 = JCB.counting()
    out = []
    for tbl in _adversarial():
        bvh = JBVH(JG.Points(jnp.asarray(vals)),
                   policy=JPolicy(route_table=tbl))
        res = bvh.query(jp)
        out.append(dict(count=np.asarray(bvh.count(jp)),
                        off=np.asarray(res.offsets),
                        idx=np.asarray(res.indices),
                        d=np.asarray(bvh.query(jk).distances),
                        cb=np.asarray(bvh.query(jp, callback=(cb, s0)))))
    return vals, qp, out


@pytest.mark.parametrize("t", range(6))
def test_adversarial_tables_change_routes_not_results(reference_results, t):
    vals, qp, ref = reference_results
    want = ref[t]
    table = TRT.RouteTable.from_dict(_adversarial()[t].to_dict())
    index = BVH(_tpts(vals), policy=CPU.override(route_table=table))
    tq = torch.from_numpy(qp)
    preds = TP.intersects(TG.Spheres(tq, torch.full((32,), 0.25)))
    assert np.array_equal(index.count(preds).numpy(), want["count"])
    res = index.query(preds)
    off = res.offsets.numpy()
    assert np.array_equal(off, want["off"])
    idx = res.indices.numpy()
    for i in range(32):
        assert set(idx[off[i]:off[i + 1]].tolist()) == \
            set(want["idx"][off[i]:off[i + 1]].tolist())
    np.testing.assert_allclose(index.query(TP.nearest(TG.Points(tq), 4))
                               .distances.numpy(), want["d"], atol=1e-5)
    cb, s0 = TCB.counting()
    got = index.query(preds, callback=(cb, s0))
    assert np.array_equal(got.numpy(), want["cb"])


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _meas(spatial_n=None, knn=None):
    rows_n = spatial_n or [(512, 10, 20), (4096, 30, 90), (32768, 80, 400),
                           (1 << 20, 900, 9000)]
    return {
        "build": {"n": 1 << 20, "ref_us": 5000.0, "pallas_us": 600.0},
        "spatial_bf": [
            dict(n=512, q=8, work=4096, bf_us=5, tree_us=9),
            dict(n=512, q=64, work=32768, bf_us=8, tree_us=9),
            dict(n=4096, q=64, work=262144, bf_us=30, tree_us=12),
            dict(n=4096, q=256, work=1 << 20, bf_us=90, tree_us=20)],
        "spatial_kernel": [dict(n=4096, q=q, kernel_us=k, loop_us=lp)
                           for q, k, lp in ((8, 50, 40), (32, 52, 60),
                                            (128, 55, 300), (512, 60, 900))]
        + [dict(n=n, q=256, kernel_us=k, loop_us=lp) for n, k, lp in rows_n],
        "knn_kernel": knn or [dict(n=n, q=256, k=8, kernel_us=k, loop_us=lp)
                              for n, k, lp in ((512, 5, 50), (4096, 9, 80))],
        "callback_kernel": [dict(n=n, q=1024, kernel_us=k, loop_us=lp)
                            for n, k, lp in ((512, 9, 8), (4096, 10, 90))],
        "spatial_block": {"128": 3.0, "256": 2.0, "512": 2.5},
        "knn_block": {"128": 3.0, "256": 4.0, "512": 2.0},
        "callback_block": {"128": 1.0, "256": 2.0, "512": 3.0},
    }


def test_tuner_derives_rules_from_measurements():
    rules, engine = TA.derive_rules(_meas())
    sp, kn, cb = rules["spatial"], rules["knn"], rules["callback"]
    assert rules["default"] == sp and engine == "pallas"
    # brute force won up to 32768 and lost from 262144: the power of two
    # at their geometric mean
    assert sp.bf_max_work == 1 << 17
    # the kernel loses to the loop at Q = 8 only
    assert sp.pallas_min_queries == 32 and sp.pallas_min_leaves == 0
    # it wins at every N measured, the largest too: no cap
    assert sp.pallas_max_nodes == TRT.UNCAPPED
    assert kn.pallas_max_nodes == TRT.UNCAPPED
    assert (sp.block_q, kn.block_q, cb.block_q) == (256, 512, 128)
    assert cb.bf_max_work == 0 and cb.pallas_min_leaves == 4096
    assert kn.bf_max_work == sp.bf_max_work
    # a cap only where the kernel lost above every N it won at
    lost = _meas(spatial_n=[(512, 10, 20), (4096, 30, 90),
                            (32768, 900, 400)])
    assert TA.derive_rules(lost)[0]["spatial"].pallas_max_nodes == 8192
    never = _meas(knn=[dict(n=512, q=256, k=8, kernel_us=90, loop_us=5)])
    kn = TA.derive_rules(never)[0]["knn"]
    assert kn.pallas_min_leaves == TRT.UNCAPPED and kn.pallas_max_nodes == 0
    slow = _meas()
    slow["build"]["pallas_us"] = 9000.0
    assert TA.derive_rules(slow)[1] == "ref"
    # the derived table is a valid one
    table = TRT.RouteTable(rules=rules, fingerprint={"torch": "x"},
                           build_engine=engine, measurements=_meas())
    assert TRT.validate_route_table(table.to_dict()) == []


def test_tuner_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        TA.measure(quick=True)


def test_validate_exit_codes(tmp_path, capsys):
    missing = str(tmp_path / "none.json")
    assert TA.main(["--validate", missing]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert TA.main(["--validate", str(bad)]) == 1
    invalid = tmp_path / "invalid.json"
    invalid.write_text(json.dumps(_rule(block_q=3)))
    assert TA.main(["--validate", str(invalid)]) == 1
    mine = tmp_path / "mine.json"
    TRT.RouteTable(rules={"default": TRT.RouteRule()},
                   fingerprint=TRT.hardware_fingerprint()).save(str(mine))
    assert TA.main(["--validate", str(mine)]) == 0
    assert "OK" in capsys.readouterr().out
    assert TA.main(["--validate", os.path.join(ROOT, "ROUTE_TABLE.json")]) \
        == 0
    assert "the engine ignores it" in capsys.readouterr().out
