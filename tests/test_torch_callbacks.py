"""PyTorch port vs the JAX package: callback queries, the general walks
and their routes (CPU; the callback kernel runs as its plain twin).

For every epilogue the port's twin (``kernels.bvh_callback`` on CPU
tensors) and its loop route (``core.traversal.traverse``) must give
per-query final states bit-identical to the JAX package's fused kernel
(``repro.kernels.bvh_callback``, interpret mode) and its while-loop walk
(``repro.core.traversal.traverse``), on one tree built by the JAX
package and carried across. Squared sums in the walks take the fused
order (``geometry.sum_sq_fused``): the boundary grid pins it.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import (CPU, ROUTE_MAP, assert_csr_equal_sets,  # noqa: F401
                               assert_knn_equal, geoms, np_of,
                               one_torch_thread)
from repro.core import BVH as JBVH
from repro.core import BruteForce as JBF
from repro.core import callbacks as JCB
from repro.core import geometry as JG
from repro.core import lbvh as JL
from repro.core import predicates as JP
from repro.core import traversal as JT
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.index import _bcast_state as j_bcast_state
from repro.kernels.bvh_callback import bvh_traverse_callback as j_callback_kernel
from repro_torch import (BVH, BruteForce, EngineConfig, ExecutionPolicy,
                         QueryEngine, RouteRule, RouteTable, convert)
from repro_torch.core import callbacks as CB
from repro_torch.core import engine as TE
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.core.index import _bcast_state
from repro_torch.core.lbvh import FIELDS
from repro_torch.kernels import bvh_callback as TK

N, Q, DIM = 300, 37, 3
TREE_ARGS = ("node_lo", "node_hi", "rope", "left_child", "range_last",
             "leaf_perm")


def _value_arrays(vkind, n=N, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n, DIM)).astype(np.float32)
    if vkind == "points":
        return [c]
    if vkind == "boxes":
        return [c, (c + rng.uniform(0.01, 0.06, c.shape)).astype(np.float32)]
    return [c, rng.uniform(0.01, 0.05, n).astype(np.float32)]


def _query_arrays(qkind, values_c, q=Q, seed=51):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (q, DIM)).astype(np.float32)
    if qkind == "points":            # half of them exact value coordinates
        c[::2] = values_c[:q:2]
        return [c]
    if qkind == "boxes":
        return [c, (c + np.float32(0.15)).astype(np.float32)]
    return [c, np.full((q,), 0.25, np.float32)]


def _carry(jtree):
    return convert.lbvh_from_numpy({f: np.asarray(getattr(jtree, f))
                                    for f in FIELDS}, CPU)


@functools.lru_cache(maxsize=None)
def _scene(vkind, qkind="spheres", n=N, q=Q, seed=1):
    """(jax_tree, port_tree, (jax_values, port_values),
    (jax_preds, port_preds)); the port tree is the JAX tree carried
    across."""
    varr = _value_arrays(vkind, n, seed)
    jv, tv = geoms(vkind, varr)
    jtree = JL.build(JG.to_boxes(jv))
    jg, tg = geoms(qkind, _query_arrays(qkind, varr[0], q, seed + 50))
    return jtree, _carry(jtree), (jv, tv), (JP.intersects(jg),
                                            TP.intersects(tg))


def _flags_weights(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random(n) < 0.5,
            rng.integers(0, 10 * n, n).astype(np.int32))


def _factories(name, n=N):
    """(jax (cb, state0), port (cb, state0)) of one callback."""
    if name == "min_where":
        flags, weights = _flags_weights(n)
        jf, jw, big = jnp.asarray(flags), jnp.asarray(weights), 10**6

        def jcb(state, pred, value, index, t):
            w = jnp.where(jf[index], jw[index], jnp.int32(big))
            return jnp.minimum(state, w), jnp.bool_(False)

        return (jcb, jnp.int32(big)), CB._min_where(
            torch.from_numpy(flags), torch.from_numpy(weights), big)
    make = {"counting": lambda m: m.counting(),
            "count_with_limit": lambda m: m.count_with_limit(3),
            "min_distance": lambda m: m.min_distance(),
            "collect_first_k": lambda m: m.collect_first_k(5),
            "collect_first_k_no_exit": lambda m: m.collect_first_k(4, False),
            "collect_hits": lambda m: m.collect_hits(16)}[name]
    return make(JCB), make(CB)


def _leaves(state):
    return list(state) if isinstance(state, (tuple, list)) else [state]


def _assert_states_equal(want, got):
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = np.asarray(w), np_of(g)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


def _run_all(jtree, ttree, values, preds, jcall, tcall, min_pos=None):
    """JAX walk, JAX kernel, port twin and port loop walk on one input;
    all four states must agree bit for bit. Returns the port twin's."""
    (jv, tv), (jp, tp) = values, preds
    (jcb, js0), (tcb, ts0) = jcall, tcall
    js0b = j_bcast_state(js0, len(jp))
    ts0b = _bcast_state(ts0, len(tp), CPU)
    jmp = None if min_pos is None else jnp.asarray(min_pos)
    tmp = None if min_pos is None else torch.from_numpy(min_pos)
    want = JT.traverse(jtree, jv, jp, jcb, js0b, min_pos=jmp)
    _assert_states_equal(want, j_callback_kernel(
        *(getattr(jtree, f) for f in TREE_ARGS), jv, jp, jcb, js0b,
        min_pos=jmp, bq=64, interpret=True))
    twin = TK.bvh_traverse_callback(*(getattr(ttree, f) for f in TREE_ARGS),
                                    tv, tp, tcb, ts0b, min_pos=tmp)
    _assert_states_equal(want, twin)
    _assert_states_equal(want, TT.traverse(ttree, tv, tp, tcb, ts0b,
                                           min_pos=tmp))
    return twin


EPILOGUES = ["counting", "count_with_limit", "min_distance",
             "collect_first_k", "collect_hits", "min_where"]


@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("name", EPILOGUES)
def test_epilogues_bit_identical_to_reference(name, vkind):
    jtree, ttree, values, preds = _scene(vkind)
    jcall, tcall = _factories(name)
    assert isinstance(tcall[0], CB.Epilogue)
    twin = _run_all(jtree, ttree, values, preds, jcall, tcall)
    if name == "counting":
        assert int(np_of(twin).sum()) > Q          # the scene has matches


@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("qkind", ["points", "boxes", "spheres"])
def test_every_predicate_value_pair(qkind, vkind):
    """The kernel's leaf test per (predicate, value) geometry pair, with
    the matches in walk order."""
    jtree, ttree, values, preds = _scene(vkind, qkind)
    jcall, tcall = _factories("collect_hits")
    twin = _run_all(jtree, ttree, values, preds, jcall, tcall)
    assert int(np_of(twin[0]).sum()) > 0


@functools.lru_cache(maxsize=None)
def _grid():
    ax = (np.arange(6, dtype=np.float32) * np.float32(0.1)).astype(np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.float32)


@pytest.mark.parametrize("factor", [2.0, 3.0])
@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
def test_boundary_grid_bit_identical(vkind, factor):
    """Grid spaced 0.1 with sphere queries of radius 0.1*sqrt(factor):
    many pairs sit within an ulp of the boundary, where the sqrt form
    (Spheres over Points and Spheres), the squared form (over Boxes), the
    node test and the order of the squared sum all decide."""
    g = _grid()
    r = np.float32(0.1) * np.sqrt(np.float32(factor))
    if vkind == "points":
        varr, rq = [g], r
    elif vkind == "boxes":
        varr, rq = [g, (g + np.float32(0.05)).astype(np.float32)], r
    else:
        varr, rq = [g, np.full((len(g),), 0.05, np.float32)], r - np.float32(0.05)
    jv, tv = geoms(vkind, varr)
    jtree = JL.build(JG.to_boxes(jv))
    jg, tg = geoms("spheres", [g, np.full((len(g),), rq, np.float32)])
    twin = _run_all(jtree, _carry(jtree), (jv, tv),
                    (JP.intersects(jg), TP.intersects(tg)),
                    *_factories("counting", len(g)))
    assert int(np_of(twin).max()) > 1


def test_early_exit_keeps_states_on_their_rows():
    """count_with_limit(1) retires most lanes after one hit while the
    rest walk on; queries without matches keep state 0."""
    jtree, ttree, values, (jp, tp) = _scene("points")
    rng = np.random.default_rng(7)
    r = np.where(rng.random(Q) < 0.3, 0.001, 0.2).astype(np.float32)
    c = np.asarray(jp.geom.center)
    jg, tg = geoms("spheres", [c, r])
    twin = _run_all(jtree, ttree, values, (JP.intersects(jg), TP.intersects(tg)),
                    (JCB.count_with_limit(1)), CB.count_with_limit(1))
    got = np_of(twin)
    assert set(np.unique(got)) == {0, 1}


def test_min_pos_filter_matches_reference():
    jtree, ttree, values, preds = _scene("points")
    min_pos = np.random.default_rng(8).integers(-1, N, Q).astype(np.int32)
    _run_all(jtree, ttree, values, preds, *_factories("collect_hits"),
             min_pos=min_pos)


def test_collect_first_k_without_early_exit():
    jtree, ttree, values, preds = _scene("boxes")
    _run_all(jtree, ttree, values, preds,
             *_factories("collect_first_k_no_exit"))


# ---------------------------------------------------------------------------
# plain callables on the loop route
# ---------------------------------------------------------------------------

def test_sum_payload_with_attached_data_takes_the_loop_route():
    jtree, ttree, (jv, tv), (jp, tp) = _scene("points")
    data = np.arange(Q, dtype=np.float32)
    jcb = JCB.sum_payload(lambda pred, value: pred.data + value.coords[0])
    tcb = CB.sum_payload(lambda pred, value: pred.data + value.coords[:, 0])
    jp = JP.attach_data(jp, jnp.asarray(data))
    tp = TP.attach_data(tp, torch.from_numpy(data))
    want = JBVH(jv).query(jp, callback=(jcb, jnp.float32(0)))
    engine = QueryEngine()
    index = BVH(tv, policy=ExecutionPolicy(device=CPU, engine=engine))
    assert engine.route_callback(index, tp, tcb) == TE.ROUTE_LOOP
    got = index.query(tp, callback=(tcb, torch.tensor(0.0)))
    _assert_states_equal(want, got)
    assert engine.callback_batches == {"kernel": 0, "loop": 1}
    _assert_states_equal(want, TT.traverse(
        ttree, tv, tp, tcb, _bcast_state(torch.tensor(0.0), Q, CPU)))


def test_bool_state_stays_bool_on_the_loop_route():
    jtree, ttree, values, preds = _scene("spheres", n=150, q=17)

    def jcb(state, pred, value, index, t):
        return (state[0] | (index % 2 == 0), state[1] + 1), jnp.bool_(False)

    def tcb(state, pred, value, index, t):
        return (state[0] | (index % 2 == 0), state[1] + 1), False

    (jv, tv), (jp, tp) = values, preds
    s0 = (False, 0)
    want = JT.traverse(jtree, jv, jp, jcb, j_bcast_state(
        (jnp.bool_(False), jnp.int32(0)), len(jp)))
    got = TT.traverse(ttree, tv, tp, tcb, _bcast_state(s0, len(tp), CPU))
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    _assert_states_equal(want, got)
    with pytest.raises(ValueError, match="epilogues"):
        TK.bvh_traverse_callback(*(getattr(ttree, f) for f in TREE_ARGS), tv,
                                 tp, tcb, _bcast_state(s0, len(tp), CPU))


# ---------------------------------------------------------------------------
# through the index: out=, loop routes, brute force, degenerate sizes
# ---------------------------------------------------------------------------

def _policy(route):
    return ExecutionPolicy(device=CPU,
                           engine=QueryEngine(EngineConfig(force=route)))


def _jax_policy(route):
    from repro.core.index import ExecutionPolicy as JPolicy
    return JPolicy(engine=JQueryEngine(JEngineConfig(force=ROUTE_MAP[route])))


def test_query_out_matches_reference():
    _, _, (jv, tv), (jp, tp) = _scene("points")
    jres = JBVH(jv).query(jp, out=lambda p, v, i, t: v.coords[0] * 2 + i + t,
                          policy=_jax_policy("kernel"))
    tres = BVH(tv, policy=_policy("kernel")).query(
        tp, out=lambda p, v, i, t: v.coords[:, 0] * 2 + i + t)
    np.testing.assert_array_equal(np_of(tres.offsets), np.asarray(jres.offsets))
    np.testing.assert_array_equal(np_of(tres.indices), np.asarray(jres.indices))
    _assert_states_equal(jres.values, tres.values)


@pytest.mark.parametrize("route", ["loop", "kernel"])
def test_spheres_values_are_answered(route):
    """An Intersects query over Spheres values leaves the spatial kernel
    (its box test is not the spheres' test): count and fill run the
    counting / collect_hits callbacks, on the callback kernel or the
    loop."""
    _, _, (jv, tv), (jp, tp) = _scene("spheres")
    no_brute_force = RouteTable(rules={"default": RouteRule(bf_max_work=0)})
    engine = QueryEngine(EngineConfig(route_table=no_brute_force,
                                      force="loop" if route == "loop" else None))
    index = BVH(tv, policy=ExecutionPolicy(device=CPU, engine=engine))
    jindex = JBVH(jv)
    jres = jindex.query(jp, policy=_jax_policy("loop"))
    tres = index.query(tp)
    assert_csr_equal_sets(tres.offsets, tres.indices, jres.offsets,
                          jres.indices)
    np.testing.assert_array_equal(np_of(index.count(tp)),
                                  np.asarray(jindex.count(jp)))
    assert engine.callback_batches[route] == 3     # count, fill, count
    assert engine.callback_batches["kernel" if route == "loop" else "loop"] == 0


@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
def test_traverse_knn_matches_reference(vkind, labels):
    jtree, ttree, (jv, tv), (jp, tp) = _scene(vkind)
    k = 6
    kw_j, kw_t = {}, {}
    if labels:
        rng = np.random.default_rng(9)
        leaf = rng.integers(0, 4, N).astype(np.int32)
        ex = rng.integers(0, 4, Q).astype(np.int32)
        kw_j = dict(exclude_labels=jnp.asarray(ex), leaf_labels=jnp.asarray(leaf))
        kw_t = dict(exclude_labels=torch.from_numpy(ex),
                    leaf_labels=torch.from_numpy(leaf))
    jd, ji = JT.traverse_knn(jtree, jv, JP.nearest(jp.geom, k), k, **kw_j)
    td, ti = TT.traverse_knn(ttree, tv, TP.nearest(tp.geom, k), k, **kw_t)
    _assert_states_equal((jd, ji), (td, ti))


def test_knn_loop_route_matches_reference():
    _, _, (jv, tv), (jp, tp) = _scene("spheres")
    jres = JBVH(jv).query(JP.nearest(jp.geom, 4), policy=_jax_policy("loop"))
    tres = BVH(tv, policy=_policy("loop")).query(TP.nearest(tp.geom, 4))
    assert_knn_equal(tres.distances, tres.indices, jres.distances,
                     jres.indices)


@pytest.mark.parametrize("vkind", ["points", "spheres"])
@pytest.mark.parametrize("name", EPILOGUES)
def test_bruteforce_callbacks_match_reference(name, vkind):
    """BruteForce applies the callback over each query's matches in index
    order, with early exit."""
    _, _, (jv, tv), (jp, tp) = _scene(vkind)
    jcall, tcall = _factories(name)
    want = JBF(jv).query(jp, callback=jcall)
    got = BruteForce(tv, policy=ExecutionPolicy(device=CPU)).query(
        tp, callback=tcall)
    _assert_states_equal(want, got)


@pytest.mark.parametrize("n", [0, 1])
def test_degenerate_sizes_run_callbacks(n):
    varr = [a[:n] for a in _value_arrays("spheres", 1)]
    jv, tv = geoms("spheres", varr)
    _, _, _, (jp, tp) = _scene("spheres")
    for name in ("counting", "collect_hits"):
        jcall, tcall = _factories(name)
        want = JBVH(jv).query(jp, callback=jcall)
        got = BVH(tv, policy=ExecutionPolicy(device=CPU)).query(
            tp, callback=tcall)
        _assert_states_equal(want, got)


def test_collect_with_t_is_a_collect_hits_pass():
    _, _, (jv, tv), (jp, tp) = _scene("boxes")
    want = JBVH(jv)._collect_with_t(jp, 8, JBVH(jv).policy)
    index = BVH(tv, policy=ExecutionPolicy(device=CPU))
    _assert_states_equal(want, index._collect_with_t(tp, 8, index.policy))


def test_callback_routes():
    """Epilogues over Points/Boxes/Spheres take the kernel; plain
    callables, custom getters and force="loop" the loop; an epilogue with a
    state of another dtype stays on the kernel route, whose wrapper
    refuses it; a Nearest batch has no spatial walk."""
    _, _, (_, tv), (_, tp) = _scene("spheres")
    engine = QueryEngine()
    index = BVH(tv, policy=ExecutionPolicy(device=CPU, engine=engine))
    cb, _ = CB.counting()
    assert engine.route_callback(index, tp, cb) == TE.ROUTE_KERNEL
    assert engine.route_callback(index, tp, lambda *a: None) == TE.ROUTE_LOOP
    with pytest.raises(ValueError, match="counting state"):
        index.query(tp, callback=(cb, torch.tensor(0, dtype=torch.int64)))
    engine.callback_batches.update(kernel=0, loop=0)
    getter = lambda v: TG.to_boxes(v)                       # noqa: E731
    custom = BVH(tv, getter, policy=ExecutionPolicy(device=CPU, engine=engine))
    assert engine.route_callback(custom, tp, cb) == TE.ROUTE_LOOP
    loop = QueryEngine(EngineConfig(force="loop"))
    assert loop.route_callback(index, tp, cb) == TE.ROUTE_LOOP
    a = index.query(tp, callback=CB.counting())
    b = custom.query(tp, callback=CB.counting())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert engine.callback_batches == {"kernel": 1, "loop": 1}
    with pytest.raises(TypeError):
        index.query(TP.nearest(tp.geom, 2), callback=CB.counting())


@pytest.mark.parametrize("fault", ["float64_values", "float64_predicates",
                                   "short_weights", "state_shape", "dim"])
def test_callback_wrapper_refuses_what_the_kernel_cannot_take(fault):
    """The kernel route is chosen from the callback and the geometries
    alone; the wrapper raises on dtypes and layouts the kernel cannot
    read, on the CPU as on the card, and never runs them on its twin."""
    _, ttree, (_, tv), (_, tp) = _scene("spheres")
    tree = [getattr(ttree, f) for f in TREE_ARGS]
    cb, s0 = CB.counting()
    s0b = _bcast_state(s0, Q, CPU)
    if fault == "float64_values":
        tv = TG.Spheres(tv.center.double(), tv.radius.double())
    elif fault == "float64_predicates":
        tp = TP.intersects(TG.Spheres(tp.geom.center.double(),
                                      tp.geom.radius))
    elif fault == "short_weights":
        flags, weights = _flags_weights(N)
        cb, s0 = CB._min_where(torch.from_numpy(flags[:-1]),
                               torch.from_numpy(weights[:-1]), 10**6)
        s0b = _bcast_state(s0, Q, CPU)
    elif fault == "state_shape":
        s0b = s0b[:-1]
    else:
        tp = TP.intersects(TG.Spheres(tp.geom.center[:, :2], tp.geom.radius))
    before = TK.bvh_traverse_callback.launches
    with pytest.raises(ValueError, match="bvh_traverse_callback"):
        TK.bvh_traverse_callback(*tree, tv, tp, cb, s0b)
    assert TK.bvh_traverse_callback.launches == before
