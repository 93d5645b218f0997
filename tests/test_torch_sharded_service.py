"""The port's sharded serving stack (``ShardedIndexStore``,
``ShardedExecutor``) against the reference's, on the CPU: the cases of
``tests/test_sharded_service.py`` and the sharded conformance case of
``tests/test_index_conformance.py``, each against the reference at the
same R.

Every rank of a port world (``run_world``) makes the same store and
server calls with the same requests and holds every response whole;
the reference runs on a mesh of R fake host devices
(``conftest.run_subprocess``). Both write their results; the tests
compare them: kNN and ray distances bit-identical with indices equal
except among ties, within counts and overflow flags equal with equal
index sets, per-rank SAH tuples bit-identical, versions and actions
equal. Each world is also held against the single-device
``QueryServer`` of its own package over the same points.
"""
from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import pytest

from conftest import run_subprocess
from test_torch_parity import (assert_knn_equal, merge_ranks, run_world,
                               world_results)

#: R -> (values a rank, the scenario groups run)
WORLDS = {1: (64, ("store", "serve", "single", "pipe")),
          3: (32, ("serve", "pad", "pipe")),
          4: (64, ("store", "serve", "race", "pipe"))}

#: requests of the pipeline part (one client, submitted in one order)
PIPE_N = 12

DATA = """
R_, NL, PARTS = {ranks}, {nl}, {parts!r}
N = R_ * NL
PTS = np.random.default_rng(1).uniform(0, 1, (N, 3)).astype(np.float32)
SCRAMBLE = (np.random.default_rng(2).permutation(PTS) * 4).astype(np.float32)
WRECK = PTS.copy()                     # one rank's block scrambled
WRECK[:NL] = np.random.default_rng(3).permutation(WRECK[:NL]) * 50
QA = np.random.default_rng(6).uniform(0, 1, (13, 3)).astype(np.float32)
DIRS = np.random.default_rng(7).normal(size=(13, 3)).astype(np.float32)
TARGETS = np.random.default_rng(5).integers(0, N, 13)
AX_O = PTS[TARGETS].copy()             # axis rays through points
AX_O[:, 0] -= 1.0
AX_D = np.tile(np.float32([1, 0, 0]), (13, 1))
PIPE_N = %d

def pipe_reqs():
    # (request, deadline_us): kNN, within and ray requests of 1-4 rows in
    # turn, every second one with a 20 ms deadline
    rng = np.random.default_rng(9)
    reqs = []
    for n in range(PIPE_N):
        a = rng.uniform(0, 1, (int(rng.integers(1, 5)), 3)).astype(np.float32)
        if n %% 3 == 0:
            r = knn_request(a, 3)
        elif n %% 3 == 1:
            r = within_request(a, 0.3)
        else:
            r = ray_request(a, rng.normal(size=a.shape).astype(np.float32), 2)
        reqs.append((r, 20_000.0 if n %% 2 else None))
    return reqs

def pipe_out(rs):
    for n, r in enumerate(rs):
        out[f"lead_pipe{{n}}_route"] = np.array(r.stats.route)
        for f in ("dists", "idxs", "counts"):
            if getattr(r, f) is not None:
                out[f"lead_pipe{{n}}_{{f}}"] = getattr(r, f)
        out[f"lead_pipe{{n}}_over"] = np.array(r.overflow)

def pipe_entry(n, e):
    out[f"lead_pipe_e{{n}}"] = np.array([e.version, e.action == "refit"])
    out[f"lead_pipe_e{{n}}_sah"] = np.array(e.sah, np.float64)

#: the pipeline part's updates: a drift (refit), a scramble (rebuild),
#: back home
PIPE_MOVES = (PTS + np.float32(0.01), SCRAMBLE, PTS)
""" % PIPE_N

#: the same scenarios in both packages: `mine(x)` is this rank's block
#: of x (all of it in the reference), `points(x)` a Points of it, and
#: `make_store(**kw)` a ShardedIndexStore over the world
SCENARIOS = """
def cfg(**kw):
    return ServiceConfig(capacity=kw.pop("capacity", 8), min_bucket=8,
                         max_bucket=32, **kw)

def reqs():
    return [knn_request(QA, 3), within_request(QA, 0.3),
            ray_request(QA, DIRS, 2), knn_request(QA, 1), knn_request(QA, 5),
            within_request(QA, 0.5), ray_request(AX_O, AX_D, 1)]

def responses(key, rs):
    for n, r in enumerate(rs):
        out[f"rep_{{key}}{{n}}_route"] = np.array(r.stats.route)
        for f in ("dists", "idxs", "counts"):
            if getattr(r, f) is not None:
                out[f"rep_{{key}}{{n}}_{{f}}"] = getattr(r, f)
        out[f"rep_{{key}}{{n}}_over"] = np.array(r.overflow)

def entry(key, e):
    out[f"rep_{{key}}_action"] = np.array(e.action)
    out[f"rep_{{key}}_version"] = np.array(e.version)
    out[f"rep_{{key}}_sah"] = np.array(e.sah, np.float64)
    out[f"rep_{{key}}_built"] = np.array(e.sah_built, np.float64)
    out[f"rep_{{key}}_refits"] = np.array(e.refits_since_build)
    out[f"rep_{{key}}_deg"] = np.array(e.degradation)
    out[f"rep_{{key}}_size"] = np.array(e.tree.size())
    out[f"rep_{{key}}_dim"] = np.array(e.dim)

if "store" in PARTS:
    store = make_store()
    entry("e1", store.build("pts", mine(PTS)))
    entry("e2", store.update("pts", points(mine(PTS) + np.float32(0.01))))
    entry("e3", store.update("pts", points(mine(SCRAMBLE))))
    entry("e4", store.update("pts", mine(PTS[:N // 2])))
    if R_ > 1:
        store.update("pts", mine(PTS))
        entry("e6", store.update("pts", points(mine(WRECK))))
    store = make_store(keep_versions=1)
    store.build("pts", mine(PTS))
    pinned = store.pin("pts")
    for tag in (1, 2, 3):
        store.update("pts", points(mine(PTS) + np.float32(tag)))
    held = store.get("pts", 1) is pinned
    store.release(pinned)
    try:
        store.get("pts", 1)
        gone = False
    except KeyError:
        gone = True
    out["rep_pins"] = np.array([store.get("pts").version, held, gone])

if "serve" in PARTS:
    c = cfg(capacity=64)
    sharded = QueryServer(store=make_store(), config=c)
    sharded.create_index("default", mine(PTS))
    responses("sharded", sharded.handle(reqs()))
    if plain_store is not None:
        plain = QueryServer(store=plain_store(), config=c)
        plain.create_index("default", points(PTS))
        responses("plain", plain.handle(reqs()))

if "single" in PARTS:
    srv = QueryServer(store=make_store(), config=cfg())
    srv.create_index("default", mine(PTS))
    srv.warmup("default")
    (resp,) = srv.handle([knn_request(QA[:4], 1)])
    out["rep_warm_hit"] = np.array(resp.stats.cache_hit)

if "pad" in PARTS or "single" in PARTS:
    srv = QueryServer(store=make_store(), config=ServiceConfig(
        capacity=4, min_bucket=2, max_bucket=8))
    srv.create_index("default", mine(PTS))
    responses("pad", srv.handle([knn_request(QA[:2], 2),
                                 within_request(QA[:1], 0.3)]))

if "race" in PARTS or "single" in PARTS:
    store = make_store(keep_versions=1)
    srv = QueryServer(store=store, config=cfg())
    srv.create_index("pts", mine(PTS))
    real = SRV.execute_group
    observed = []

    def racing_execute(engine, config, e, group):
        for tag in (1, 2, 3):                   # refits land mid-dispatch
            pub = store.update("pts", points(mine(PTS) + np.float32(tag) * 0.01))
            observed.append(pub.action == "refit")
        observed.append(store.get("pts", e.version) is e)
        observed.append(e.version)
        return real(engine, config, e, group)

    SRV.execute_group = racing_execute
    (resp,) = srv.handle([knn_request(QA[:4], 2, "pts")])
    SRV.execute_group = real
    try:
        store.get("pts", 1)
        gone = False
    except KeyError:
        gone = True
    out["rep_race"] = np.array(observed + [resp.stats.index_version,
                                           len(store._pins), gone,
                                           store.get("pts").version])
    out["rep_race_idxs"] = resp.idxs
"""

REF = """
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core import geometry as G
from repro.service import (PipelineConfig, QueryServer, ServiceConfig,
                           ServingPipeline, ShardedIndexStore, knn_request,
                           ray_request, within_request)
from repro.service import server as SRV
""" + DATA + """
out = {{}}
mesh = make_mesh((R_,), ("data",))

def mine(x):
    return x

def points(x):
    return G.Points(jnp.asarray(x))

def make_store(**kw):
    return ShardedIndexStore(mesh, "data", **kw)

plain_store = None
""" + SCENARIOS + """
if "single" in PARTS:
    with ServingPipeline(store=make_store(),
                         config=PipelineConfig(service=cfg())) as pipe:
        pipe.create_index("default", PTS)
        r1 = pipe.submit(knn_request(QA[:4], 2)).result(60.0)
        pipe.update_index("default", points(PTS + np.float32(0.01)))
        assert pipe.wait_maintenance_idle(60.0)
        r2 = pipe.submit(knn_request(QA[4:8], 2)).result(60.0)
        out["rep_pipe"] = np.array([r1.stats.route == "sharded",
                                    r1.stats.index_version,
                                    r2.stats.index_version,
                                    pipe.stats().refits])
        out["rep_pipe_d"] = np.concatenate([r1.dists, r2.dists])
        out["rep_pipe_i"] = np.concatenate([r1.idxs, r2.idxs])

if "pipe" in PARTS:
    with ServingPipeline(store=sharded.store,
                         config=PipelineConfig(service=c)) as pipe:
        tickets = [pipe.submit(r, deadline_us=d) for r, d in pipe_reqs()]
        pipe_out([t.result(120.0) for t in tickets])
        for n, values in enumerate(PIPE_MOVES):
            pipe.update_index("default", points(values))
            assert pipe.wait_maintenance_idle(120.0)
            pipe_entry(n, pipe.store.get("default"))
np.savez(OUT, **out)
print("REF OK")
"""

PORT = """
import repro_torch.service.server as SRV
from repro_torch import EngineConfig, QueryEngine
from repro_torch.core import geometry as G
from repro_torch.service import (IndexStore, PipelineConfig, QueryServer,
                                 ServiceConfig, ServingPipeline,
                                 ShardedIndexStore, knn_request, ray_request,
                                 within_request)
""" + DATA + """
out = {{}}

def mine(x):
    return x[RANK * (len(x) // RANKS):(RANK + 1) * (len(x) // RANKS)]

def points(x):
    return G.Points(torch.from_numpy(np.ascontiguousarray(x)))

def make_store(**kw):
    return ShardedIndexStore(None, device="cpu", **kw)

def plain_store():
    # the kernel route, which the sharded local steps take too
    return IndexStore(QueryEngine(EngineConfig(force="kernel")),
                      device="cpu")
""" + SCENARIOS + """
if "single" in PARTS:
    with ServingPipeline(store=make_store(),
                         config=PipelineConfig(service=cfg())) as pipe:
        pipe.create_index("default", PTS)
        r1 = pipe.submit(knn_request(QA[:4], 2)).result(60.0)
        pipe.update_index("default", points(PTS + np.float32(0.01)))
        assert pipe.wait_maintenance_idle(60.0)
        r2 = pipe.submit(knn_request(QA[4:8], 2)).result(60.0)
        out["rep_pipe"] = np.array([r1.stats.route == "sharded",
                                    r1.stats.index_version,
                                    r2.stats.index_version,
                                    pipe.stats().refits])
        out["rep_pipe_d"] = np.concatenate([r1.dists, r2.dists])
        out["rep_pipe_i"] = np.concatenate([r1.idxs, r2.idxs])

if "pipe" in PARTS:
    # the leader (rank 0) takes every request and index write; the last
    # rank fails one kNN group (k = 4) and its fourth refit on purpose
    import time
    import torch.distributed as dist
    from repro_torch.service import sharded as SH
    pipe = ServingPipeline(store=sharded.store,
                           config=PipelineConfig(service=c))
    refused = True
    if RANK > 0:
        try:
            pipe.submit(knn_request(QA[:2], 3))
            refused = False
        except RuntimeError as e:
            refused = "call submit on rank 0" in str(e)
    if RANKS > 1 and RANK == RANKS - 1:
        engine = sharded.store.engine
        real_knn, real_refit, refits = engine.exec_knn, \
            SH.lbvh.refit_with_quality, []

        def failing_knn(bvh, preds):
            if preds.k == 4:
                raise RuntimeError("injected kNN fault")
            return real_knn(bvh, preds)

        def failing_refit(tree, boxes):
            refits.append(1)
            if len(refits) == 4:
                raise RuntimeError("injected refit fault")
            return real_refit(tree, boxes)

        engine.exec_knn = failing_knn
        SH.lbvh.refit_with_quality = failing_refit
    dist.barrier()                      # the faults are armed
    if RANK == 0:
        tickets = [pipe.submit(r, deadline_us=d) for r, d in pipe_reqs()]
        pipe_out([t.result(120.0) for t in tickets])
        for n, values in enumerate(PIPE_MOVES):
            pipe.update_index("default", points(values))
            assert pipe.wait_maintenance_idle(120.0)
            pipe_entry(n, pipe.store.get("default"))
        if RANKS > 1:
            t0 = time.monotonic()
            try:
                pipe.submit(knn_request(QA[:3], 4)).result(120.0)
                fault = "none"
            except Exception as e:
                fault = f"{{type(e).__name__}}: {{e}}"
            out["lead_pipe_fault"] = np.array(fault)
            out["lead_pipe_fault_s"] = np.array(time.monotonic() - t0)
            after = pipe.submit(knn_request(QA[:3], 3)).result(120.0)
            out["lead_pipe_after"] = after.dists
            vers = [pipe.store.get("default").version]
            for shift in (0.02, 0.03):
                pipe.update_index("default", points(PTS + np.float32(shift)))
                assert pipe.wait_maintenance_idle(120.0)
                vers.append(pipe.store.get("default").version)
            out["lead_pipe_maint"] = np.array(vers)
        pipe.close()
    else:
        pipe.close(timeout=200.0)
    s = pipe.stats()
    out["rank_pipe_final"] = np.array([
        sharded.store.get("default").version, refused,
        pipe._scheduler.is_alive() or pipe._maintainer.is_alive(),
        pipe.error is not None, s.batches, s.failed, s.swap_count,
        s.refits, s.rebuilds, s.maintenance_errors])
save(**out)
print("PORT OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{R: (reference, port)} results of every world, all run at once."""
    tmp = tmp_path_factory.mktemp("sharded")

    def ref(r):
        path = os.path.join(tmp, f"ref{r}.npz")
        nl, parts = WORLDS[r]
        code = REF.format(ranks=r, nl=nl, parts=parts).replace(
            "np.savez(OUT,", f"np.savez({path!r},")
        run_subprocess(code, devices=r, timeout=240)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def port(r):
        out = os.path.join(tmp, f"port{r}")
        os.makedirs(out)
        nl, parts = WORLDS[r]
        run_world(PORT.format(ranks=r, nl=nl, parts=parts), r, timeout=240,
                  out=out)
        # the pipeline's leader alone holds the responses (``lead_*``)
        ranks = world_results(out, r)
        merged = merge_ranks([{k: v for k, v in p.items()
                               if not k.startswith("lead_")} for p in ranks])
        merged.update({k: v for k, v in ranks[0].items()
                       if k.startswith("lead_")})
        return merged

    with concurrent.futures.ThreadPoolExecutor(2 * len(WORLDS)) as pool:
        refs = {r: pool.submit(ref, r) for r in WORLDS}
        ports = {r: pool.submit(port, r) for r in WORLDS}
        return {r: (refs[r].result(), ports[r].result()) for r in WORLDS}


def cases(part, keys=(None,)):
    """(R, key) for every world that runs the scenario group `part`."""
    return [(r, key) if key is not None else r for r in sorted(WORLDS)
            if part in WORLDS[r][1] for key in keys]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


#: the served requests: (kind, index in reqs())
REQS = [("knn", 0), ("within", 1), ("ray", 2), ("knn", 3), ("knn", 4),
        ("within", 5), ("ray", 6)]


def _assert_response(want, got, key, kind):
    assert str(got[key + "_route"]) == str(want[key + "_route"])
    if kind == "within":
        np.testing.assert_array_equal(got[key + "_counts"],
                                      want[key + "_counts"])
        assert got[key + "_over"] == want[key + "_over"]
        cap = got[key + "_idxs"].shape[1]
        for n, g, w in zip(got[key + "_counts"], got[key + "_idxs"],
                           want[key + "_idxs"]):
            if n <= cap:        # an overflowing row truncates by route
                assert set(g[g >= 0].tolist()) == set(w[w >= 0].tolist())
    else:
        np.testing.assert_array_equal(_bits(got[key + "_dists"]),
                                      _bits(want[key + "_dists"]))
        assert_knn_equal(got[key + "_dists"], got[key + "_idxs"],
                         want[key + "_dists"], want[key + "_idxs"])


# ---------------------------------------------------------------------------
# serving: equal to the reference's sharded server, and to the
# single-device QueryServer of the same package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,req", cases("serve", range(len(REQS))))
def test_sharded_serving_matches_the_reference(runs, r, req):
    want, got = runs[r]
    kind, n = REQS[req]
    assert str(got[f"rep_sharded{n}_route"]) == "sharded"
    _assert_response(want, got, f"rep_sharded{n}", kind)


@pytest.mark.parametrize("r,req", cases("serve", range(len(REQS))))
def test_sharded_serving_matches_the_single_device_server(runs, r, req):
    """The port's single-device QueryServer over all the points, its
    engine held to the kernel route (which the local steps take): the
    same distances bit for bit."""
    _, got = runs[r]
    kind, n = REQS[req]
    sharded = {k.replace(f"rep_sharded{n}", "x"): v for k, v in got.items()
               if k.startswith(f"rep_sharded{n}_")}
    plain = {k.replace(f"rep_plain{n}", "x"): v for k, v in got.items()
             if k.startswith(f"rep_plain{n}_")}
    assert str(plain["x_route"]) == "kernel"
    sharded["x_route"] = plain["x_route"]
    _assert_response(plain, sharded, "x", kind)


@pytest.mark.parametrize("r", cases("serve"))
def test_axis_rays_hit_their_points(runs, r):
    """The conformance case: axis rays through known points hit at or
    before them, on points that lie on the ray."""
    _, got = runs[r]
    t = got["rep_sharded6_dists"][:, 0]
    assert np.isfinite(t).all() and (t <= 1.0 + 1e-4).all()


# ---------------------------------------------------------------------------
# the store: build / refit / rebuild, per-rank SAH, pins
# ---------------------------------------------------------------------------

#: per-rank SAH: ``lbvh.sah_cost`` adds its node areas in another order
#: than XLA's sum, so it agrees to float32 rounding, as
#: tests/test_torch_index_store.py holds the single-device store
SAH_RTOL = 1e-5


@pytest.mark.parametrize("r,e", cases("store", ["e1", "e2", "e3", "e4"]))
def test_store_actions_and_per_rank_sah(runs, r, e):
    want, got = runs[r]
    for f in ("action", "version", "refits", "size", "dim"):
        key = f"rep_{e}_{f}"
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for f in ("sah", "built", "deg"):
        key = f"rep_{e}_{f}"
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=SAH_RTOL,
                                   err_msg=key)
    assert got[f"rep_{e}_sah"].shape == (r,)


def test_store_action_sequence(runs):
    _, got = runs[1]
    assert [str(got[f"rep_{e}_action"]) for e in ("e1", "e2", "e3", "e4")] \
        == ["build", "refit", "rebuild", "rebuild"]
    assert float(got["rep_e1_deg"]) == 1.0


@pytest.mark.parametrize("r", [r for r in cases("store") if r > 1])
def test_the_worst_rank_decides_a_rebuild(runs, r):
    """One rank's block scrambled: its SAH alone trips the monitor, and
    every rank rebuilds."""
    want, got = runs[r]
    assert str(got["rep_e6_action"]) == str(want["rep_e6_action"]) \
        == "rebuild"
    np.testing.assert_allclose(got["rep_e6_sah"], want["rep_e6_sah"],
                               rtol=SAH_RTOL)


@pytest.mark.parametrize("r", cases("store"))
def test_pins_survive_trimming(runs, r):
    want, got = runs[r]
    np.testing.assert_array_equal(got["rep_pins"], want["rep_pins"])
    assert got["rep_pins"].tolist() == [4, 1, 1]


def test_a_store_needs_a_process_group():
    import torch.distributed as dist
    from repro_torch.service import ShardedIndexStore
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        ShardedIndexStore(device="cpu")


# ---------------------------------------------------------------------------
# warm plans, bucket padding, the mid-flight refit, the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", cases("single"))
def test_warmup_leaves_plans_warm(runs, r):
    want, got = runs[r]
    assert got["rep_warm_hit"] and want["rep_warm_hit"]


@pytest.mark.parametrize("r,req", [(r, n) for r in sorted(WORLDS)
                                   if {"pad", "single"} & set(WORLDS[r][1])
                                   for n in (0, 1)])
def test_buckets_pad_to_a_multiple_of_the_ranks(runs, r, req):
    """min_bucket 2: a bucket of 2 rows pads to 3 at R = 3, and the
    results slice back to the requests' rows."""
    want, got = runs[r]
    key = f"rep_pad{req}"
    _assert_response(want, got, key, ("knn", "within")[req])
    assert got[key + "_idxs"].shape == ((2, 2) if req == 0 else (1, 4))


@pytest.mark.parametrize("r", [r for r in sorted(WORLDS)
                               if {"race", "single"} & set(WORLDS[r][1])])
def test_refit_publishes_mid_flight_on_the_pinned_version(runs, r):
    """Three refits land while a batch is in flight: the batch serves the
    version it pinned (still resolvable with keep_versions=1), the pins
    balance, and the released version is evicted."""
    want, got = runs[r]
    np.testing.assert_array_equal(got["rep_race"], want["rep_race"])
    assert got["rep_race"].tolist() == [1, 1, 1, 1, 1, 1, 0, 1, 4]
    assert_knn_equal(np.zeros(got["rep_race_idxs"].shape),
                     got["rep_race_idxs"],
                     np.zeros(want["rep_race_idxs"].shape),
                     want["rep_race_idxs"])


def test_pipeline_background_refit_at_a_world_of_one(runs):
    want, got = runs[1]
    np.testing.assert_array_equal(got["rep_pipe"], want["rep_pipe"])
    assert got["rep_pipe"].tolist() == [1, 1, 2, 1]
    np.testing.assert_array_equal(_bits(got["rep_pipe_d"]),
                                  _bits(want["rep_pipe_d"]))
    assert_knn_equal(got["rep_pipe_d"], got["rep_pipe_i"],
                     want["rep_pipe_d"], want["rep_pipe_i"])


# ---------------------------------------------------------------------------
# the pipeline over R ranks: a leader and its followers
# ---------------------------------------------------------------------------

#: the kind of request n of ``pipe_reqs``
PIPE_KINDS = ("knn", "within", "ray")


@pytest.mark.parametrize("r,n", cases("pipe", range(PIPE_N)))
def test_pipeline_matches_the_reference(runs, r, n):
    """The same requests submitted in the same order, half with
    deadlines: the groups depend on timing, so every request is held to
    the reference's on its own."""
    want, got = runs[r]
    key = f"lead_pipe{n}"
    assert str(got[key + "_route"]) == "sharded"
    _assert_response(want, got, key, PIPE_KINDS[n % 3])


@pytest.mark.parametrize("r", cases("pipe"))
def test_pipeline_maintenance_matches_the_reference(runs, r):
    """update_index, idle between calls: the reference's versions and
    actions (refit, rebuild, ...), and per-rank SAH bit for bit."""
    want, got = runs[r]
    for n in range(3):
        key = f"lead_pipe_e{n}"
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key + "_sah"].shape == (r,)
        np.testing.assert_array_equal(_bits(got[key + "_sah"]),
                                      _bits(want[key + "_sah"]))
    assert got["lead_pipe_e1"].tolist() == [got["lead_pipe_e0"][0] + 1, 0]


#: rank_pipe_final's columns
FINAL = ("version", "refused", "alive", "error", "batches", "failed",
         "swaps", "refits", "rebuilds", "maintenance_errors")


def _final(got):
    return {f: got["rank_pipe_final"][:, i] for i, f in enumerate(FINAL)}


@pytest.mark.parametrize("r", cases("pipe"))
def test_pipeline_close_ends_every_rank(runs, r):
    """close() on the leader stops every follower's loops (no error), and
    every rank ends on the same version, having served the same groups
    and run the same maintenance."""
    fin = _final(runs[r][1])
    assert not fin["alive"].any() and not fin["error"].any()
    for f in ("version", "batches", "failed", "swaps", "refits", "rebuilds",
              "maintenance_errors"):
        assert len(set(fin[f].tolist())) == 1, (f, fin[f])
    assert fin["batches"][0] > 0


@pytest.mark.parametrize("r", [r for r in cases("pipe") if r > 1])
def test_a_follower_refuses_submit(runs, r):
    assert _final(runs[r][1])["refused"].all()


@pytest.mark.parametrize("r", [r for r in cases("pipe") if r > 1])
def test_a_failure_on_a_follower_fails_the_leaders_tickets(runs, r):
    """A kNN group whose local walk raises on the last rank: the leader's
    ticket fails with that rank's error, well inside the collective
    timeout, and the next group serves."""
    _, got = runs[r]
    fault = str(got["lead_pipe_fault"])
    assert fault.startswith("RankFailure") and f"[{r - 1}]" in fault
    assert "injected kNN fault" in fault
    assert float(got["lead_pipe_fault_s"]) < 30.0
    assert np.isfinite(got["lead_pipe_after"]).all()
    fin = _final(got)
    assert (fin["failed"] == 1).all()


@pytest.mark.parametrize("r", [r for r in cases("pipe") if r > 1])
def test_a_maintenance_failure_is_agreed(runs, r):
    """A refit that raises on the last rank: no rank publishes it (the
    version stays), every rank counts one maintenance error, and the next
    update publishes everywhere."""
    _, got = runs[r]
    before, mid, after = got["lead_pipe_maint"].tolist()
    assert mid == before and after == before + 1
    fin = _final(got)
    assert (fin["maintenance_errors"] == 1).all()
    assert (fin["version"] == after).all()
