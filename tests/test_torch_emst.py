"""``Nearest.exclude`` and the Euclidean minimum spanning tree: the port
against the JAX reference on the CPU, and the exclusion kernel against
its twin on the card (tests marked ``cuda``).

The reference answers ``nearest(..., exclude=(query_labels,
leaf_labels))`` with its compiled loop walk, which ranks leaves by their
fine distance and never admits a leaf of the query's own label. The port
routes the batch to ``kernels.bvh_traverse.bvh_traverse_knn_exclude``,
whose CPU twin walks the same ropes with the same key and also prunes
every subtree whose leaves all carry the query's label (the reference
does not prune them), so equal lists also show that the pruning changes
nothing. Compared bit for bit (tolerance 0), ties and (inf, -1) padding
included: dims 2, 3 and 5; k = 1, 4 and 16; random labels, one label for
every point (nothing left: all (inf, -1)) and all labels distinct (the
plain kNN without the query point), and grids, whose distances tie
exactly. ``emst`` returns the reference's (eu, ev, ew) exactly.

The JAX package is imported inside the CPU tests only, so that the file
collects on a machine without JAX, where ``-m cuda`` runs its card
cases.
"""
import numpy as np
import pytest
import torch

from repro_torch import BVH, BruteForce, EngineConfig, ExecutionPolicy, QueryEngine
from repro_torch import emst
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.kernels import bvh_traverse as KT

CPU = "cpu"
POLICY = ExecutionPolicy(device=CPU)
N, Q = 240, 96
EMST_CASES = [(50, 2, 0), (120, 3, 1), (200, 3, 2), (64, 5, 3)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def grid(side, dim):
    """A side^dim integer grid: every point's nearest neighbours tie."""
    axes = np.meshgrid(*[np.arange(side)] * dim, indexing="ij")
    return np.stack(axes, -1).reshape(-1, dim).astype(np.float32)


def labels_of(kind, n, rng):
    if kind == "random":
        return rng.integers(0, 6, n).astype(np.int32)
    if kind == "one":
        return np.zeros(n, np.int32)
    return np.arange(n, dtype=np.int32)


def scene(dim, labels, seed, cloud="uniform"):
    """(values, queries, query labels, leaf labels): queries are the first
    Q values (each query's own label among the leaves) and Q fresh
    points labelled at random."""
    rng = np.random.default_rng(seed)
    x = (grid(6 if dim == 2 else 4, dim) if cloud == "grid"
         else rng.uniform(0, 1, (N, dim)).astype(np.float32))
    n = x.shape[0]
    leaf = labels_of(labels, n, rng)
    q = np.concatenate([x[:Q // 2], rng.uniform(0, x.max() + 1e-3,
                                                 (Q // 2, dim))]).astype(np.float32)
    ql = np.concatenate([leaf[:Q // 2], labels_of(labels, Q // 2, rng)])
    return x, q, ql.astype(np.int32), leaf


def reference_knn(x, q, ql, leaf, k, values="points"):
    import jax.numpy as jnp
    from repro.core import BVH as JBVH
    from repro.core import geometry as JG
    from repro.core import predicates as JP
    jv = (JG.Points(jnp.asarray(x)) if values == "points"
          else JG.Boxes(jnp.asarray(x), jnp.asarray(x + 0.05)))
    res = JBVH(jv).query(JP.nearest(JG.Points(jnp.asarray(q)), k=k,
                                    exclude=(jnp.asarray(ql), jnp.asarray(leaf))))
    return np.asarray(res.distances), np.asarray(res.indices)


def port_values(x, values="points", dev=CPU):
    t = torch.from_numpy(x).to(dev)
    return TG.Points(t) if values == "points" else TG.Boxes(t, t + 0.05)


def port_knn(x, q, ql, leaf, k, values="points", dev=CPU):
    index = BVH(port_values(x, values, dev), policy=ExecutionPolicy(device=dev))
    res = index.query(TP.nearest(
        TG.Points(torch.from_numpy(q).to(dev)), k=k,
        exclude=(torch.from_numpy(ql).to(dev), torch.from_numpy(leaf).to(dev))))
    return res.distances.cpu().numpy(), res.indices.cpu().numpy()


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Nearest.exclude on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labels", ["random", "one", "distinct"])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("dim", [2, 3, 5])
def test_exclusion_query_matches_reference(dim, k, labels):
    x, q, ql, leaf = scene(dim, labels, seed=dim * 10 + k)
    calls = TT.knn_walk.calls
    got = port_knn(x, q, ql, leaf, k)
    assert TT.knn_walk.calls == calls          # the twin, not the loop walk
    assert_same(got, reference_knn(x, q, ql, leaf, k))
    if labels == "one":
        assert (got[1] == -1).all() and np.isinf(got[0]).all()


@pytest.mark.parametrize("labels", ["random", "distinct"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_exclusion_query_on_a_grid_matches_reference(dim, k, labels):
    """Exact distance ties at every rank."""
    x, q, ql, leaf = scene(dim, labels, seed=5, cloud="grid")
    q = x[::3].copy()
    ql = leaf[::3].copy()
    got = port_knn(x, q, ql, leaf, k)
    assert_same(got, reference_knn(x, q, ql, leaf, k))
    if k > 1:       # the lists hold ties
        assert (got[0][:, 1:] == got[0][:, :-1]).any()


def test_exclusion_query_over_boxes_matches_reference():
    x, q, ql, leaf = scene(3, "random", seed=7)
    assert_same(port_knn(x, q, ql, leaf, 5, values="boxes"),
                reference_knn(x, q, ql, leaf, 5, values="boxes"))


def test_other_shapes_take_the_loop_walk():
    """Spheres queries are not the kernel's: the general walk, counted."""
    import jax.numpy as jnp
    from repro.core import BVH as JBVH
    from repro.core import geometry as JG
    from repro.core import predicates as JP
    x, q, ql, leaf = scene(3, "random", seed=8)
    r = np.full(Q, 0.05, np.float32)
    want = JBVH(JG.Points(jnp.asarray(x))).query(JP.nearest(
        JG.Spheres(jnp.asarray(q), jnp.asarray(r)), k=3,
        exclude=(jnp.asarray(ql), jnp.asarray(leaf))))
    calls = TT.knn_walk.calls
    got = BVH(port_values(x), policy=POLICY).query(TP.nearest(
        TG.Spheres(torch.from_numpy(q), torch.from_numpy(r)), k=3,
        exclude=(torch.from_numpy(ql), torch.from_numpy(leaf))))
    assert TT.knn_walk.calls == calls + 1
    assert_same((got.distances.numpy(), got.indices.numpy()),
                (np.asarray(want.distances), np.asarray(want.indices)))


@pytest.mark.parametrize("n", [0, 1])
def test_degenerate_index_takes_brute_force(n):
    x = np.array([[0.5, 0.5, 0.5]], np.float32)[:n]
    leaf = np.zeros(n, np.int32)
    q = np.array([[0.1, 0.2, 0.3], [0.5, 0.5, 0.4]], np.float32)
    for ql in (np.array([0, 1], np.int32), np.array([1, 1], np.int32)):
        d, i = port_knn(x, q, ql, leaf, 2)
        want_i = np.full((2, 2), -1, np.int32)
        want_i[:, 0] = np.where((ql != 0) & (n == 1), 0, -1)
        np.testing.assert_array_equal(i, want_i)
        assert np.isinf(d[i == -1]).all() and np.isfinite(d[i == 0]).all()


@pytest.mark.parametrize("values", ["points", "boxes"])
def test_bruteforce_exclusion_matches_reference(values):
    """BruteForce with the labels masked before its sort, held to the
    reference's BruteForce at the port's BruteForce kNN tolerance (the
    Points distances come from the |x|^2 - 2x.y + |y|^2 expansion)."""
    import jax.numpy as jnp
    from repro.core import BruteForce as JBF
    from repro.core import geometry as JG
    from repro.core import predicates as JP
    from test_torch_parity import assert_knn_equal
    x, q, ql, leaf = scene(3, "random", seed=9)
    jv = (JG.Points(jnp.asarray(x)) if values == "points"
          else JG.Boxes(jnp.asarray(x), jnp.asarray(x + 0.05)))
    want = JBF(jv).query(JP.nearest(JG.Points(jnp.asarray(q)), k=6, exclude=(
        jnp.asarray(ql), jnp.asarray(leaf))))
    got = BruteForce(port_values(x, values), policy=POLICY).query(TP.nearest(
        TG.Points(torch.from_numpy(q)), k=6,
        exclude=(torch.from_numpy(ql), torch.from_numpy(leaf))))
    assert_knn_equal(got.distances, got.indices, want.distances, want.indices,
                     atol=1e-6 if values == "points" else 0.0)
    same = leaf[np.maximum(got.indices.numpy(), 0)] == ql[:, None]
    assert not (same & (got.indices.numpy() >= 0)).any()


def test_bruteforce_blocks_slice_the_query_labels(monkeypatch):
    """Blocks of BLOCK_Q queries take their own rows of the labels."""
    from repro_torch.core import brute_force
    x, q, ql, leaf = scene(3, "random", seed=10)
    whole = BruteForce(port_values(x), policy=POLICY).query(TP.nearest(
        TG.Points(torch.from_numpy(q)), k=4,
        exclude=(torch.from_numpy(ql), torch.from_numpy(leaf))))
    monkeypatch.setattr(brute_force, "BLOCK_Q", 7)
    blocked = BruteForce(port_values(x), policy=POLICY).query(TP.nearest(
        TG.Points(torch.from_numpy(q)), k=4,
        exclude=(torch.from_numpy(ql), torch.from_numpy(leaf))))
    assert torch.equal(whole.indices, blocked.indices)
    assert torch.equal(whole.distances, blocked.distances)


def test_nearest_exclude_is_checked_moved_and_sliced():
    g = TG.Points(torch.zeros((4, 3)))
    ql, leaf = torch.arange(4, dtype=torch.int32), torch.zeros(9, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        TP.nearest(g, exclude=(ql.to(torch.int64), leaf))
    with pytest.raises(ValueError, match="one query label"):
        TP.nearest(g, exclude=(ql[:3], leaf))
    p = TP.nearest(g, k=2, exclude=(ql, leaf))
    part = TP.take(p, torch.tensor([3, 1]))
    assert part.exclude[0].tolist() == [3, 1] and part.exclude[1] is leaf
    moved = p.to(CPU)
    assert moved.exclude[0].device.type == "cpu" and len(moved.exclude) == 2


def test_engine_and_service_refuse_exclude():
    x, q, ql, leaf = scene(3, "random", seed=11)
    engine = QueryEngine(EngineConfig())
    index = BVH(port_values(x), policy=ExecutionPolicy(device=CPU, engine=engine))
    preds = TP.nearest(TG.Points(torch.from_numpy(q)), k=2, exclude=(
        torch.from_numpy(ql), torch.from_numpy(leaf)))
    with pytest.raises(ValueError, match="exclusion walk"):
        engine.route_knn(index, preds)
    with pytest.raises(ValueError, match="exclusion walk"):
        engine.exec_knn(index, preds)
    assert engine.stats.cache_misses == 0
    # BVH.query answers it whatever route the engine would pin
    for force in ("bruteforce", "kernel", "loop"):
        pinned = ExecutionPolicy(device=CPU,
                                 engine=QueryEngine(EngineConfig(force=force)))
        res = BVH(port_values(x), policy=pinned).query(preds)
        assert_same((res.distances.numpy(), res.indices.numpy()),
                    port_knn(x, q, ql, leaf, 2))


def test_node_labels_follow_the_leaves():
    """An internal node carries the one label of its leaves, else MIXED;
    a leaf its value's label (checked against the leaves below each node)."""
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    tree = BVH(port_values(x), policy=POLICY).tree
    n = 200
    for leaf in (np.repeat(np.arange(20), 10), rng.integers(0, 3, n),
                 np.zeros(n), -np.ones(n)):
        leaf = torch.from_numpy(leaf.astype(np.int32))
        got = KT.node_labels(leaf, tree.leaf_perm, tree.range_first,
                             tree.range_last).numpy()
        ls = leaf.numpy()[tree.leaf_perm.numpy()]
        np.testing.assert_array_equal(got[n - 1:], ls)
        for i in range(n - 1):
            below = ls[int(tree.range_first[i]):int(tree.range_last[i]) + 1]
            want = below[0] if (below == below[0]).all() else KT.MIXED
            assert got[i] == want


def test_label_pruning_cuts_the_twins_visits():
    """Two labels in two half-spaces: the twin skips the subtrees of the
    query's own half that a walk without the labels would enter."""
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    leaf = (x[:, 0] > 0.5).astype(np.int32)
    tree = BVH(port_values(x), policy=POLICY).tree
    arrays = [getattr(tree, f) for f in ("node_lo", "node_hi", "rope",
                                         "left_child", "leaf_perm")]
    q = torch.from_numpy(x[:64])
    ql = torch.from_numpy(leaf[:64])
    pruned, flat = {}, {}
    got = KT.bvh_traverse_knn_exclude_ref(
        *arrays, tree.range_first, tree.range_last, q, ql,
        torch.from_numpy(leaf), k=1, stats=pruned)
    # no subtree is uniform when every leaf has its own label
    KT.bvh_traverse_knn_exclude_ref(
        *arrays, tree.range_first, tree.range_last, q,
        torch.arange(64, dtype=torch.int32) + 1000,
        torch.arange(512, dtype=torch.int32) + 2000, k=1, stats=flat)
    assert pruned["visits"] < flat["visits"]
    assert (leaf[got[1][:, 0].numpy()] != leaf[:64]).all()


def test_wrapper_takes_the_twin_on_the_cpu():
    x, q, ql, leaf = scene(3, "random", seed=14)
    tree = BVH(port_values(x), policy=POLICY).tree
    arrays = [getattr(tree, f) for f in ("node_lo", "node_hi", "rope",
                                         "left_child", "leaf_perm",
                                         "range_first", "range_last")]
    before = KT.bvh_traverse_knn_exclude.launches
    args = (*arrays, torch.from_numpy(q), torch.from_numpy(ql),
            torch.from_numpy(leaf))
    got = KT.bvh_traverse_knn_exclude(*args, k=3)
    assert KT.bvh_traverse_knn_exclude.launches == before
    want = KT.bvh_traverse_knn_exclude_ref(*args, k=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="k must be"):
        KT.bvh_traverse_knn_exclude(*args, k=0)


# ---------------------------------------------------------------------------
# EMST on the CPU
# ---------------------------------------------------------------------------

def reference_emst(x):
    from repro.core import emst as jemst
    return [np.asarray(a) for a in jemst(x)]


def port_emst(x, dev=CPU, stats=None):
    return [a.cpu().numpy() for a in emst(x, device=dev, stats=stats)]


@pytest.mark.parametrize("n,dim,seed", EMST_CASES)
def test_emst_matches_reference(n, dim, seed):
    x = np.random.default_rng(seed).uniform(0, 1, (n, dim)).astype(np.float32)
    stats = {}
    got = port_emst(x, stats=stats)
    for a, b in zip(got, reference_emst(x)):
        np.testing.assert_array_equal(a, b)
    assert 1 <= stats["rounds"] <= int(np.ceil(np.log2(n)))
    assert stats["host_syncs"] >= 2 * stats["rounds"]


@pytest.mark.parametrize("dim", [2, 3])
def test_emst_on_a_grid_matches_reference(dim):
    x = grid(9 if dim == 2 else 5, dim)
    for a, b in zip(port_emst(x), reference_emst(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2])
def test_emst_of_one_or_two_points_matches_reference(n):
    x = np.array([[0.1, 0.2, 0.3], [0.4, 0.0, 0.9]], np.float32)[:n]
    got = port_emst(x)
    assert [a.shape for a in got] == [(n - 1,)] * 3
    assert [a.dtype for a in got] == [np.int32, np.int32, np.float32]
    for a, b in zip(got, reference_emst(x)):
        np.testing.assert_array_equal(a, b)


def _prim_weight(x):
    d = np.linalg.norm(x[:, None].astype(np.float64) - x[None], axis=-1)
    intree = np.zeros(len(x), bool)
    intree[0] = True
    best = d[0].copy()
    total = 0.0
    for _ in range(len(x) - 1):
        j = int(np.argmin(np.where(intree, np.inf, best)))
        total += best[j]
        intree[j] = True
        best = np.minimum(best, d[j])
    return total


@pytest.mark.parametrize("cloud", ["uniform", "clusters"])
def test_emst_is_a_spanning_tree_of_prims_weight(cloud):
    """N - 1 edges, no cycle, one component, and the total weight of
    Prim's tree in float64 within 1e-4 relative (the edge lengths are
    float32 distances, each within about 2 u of its float64 value)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    rng = np.random.default_rng(15)
    n = 300
    if cloud == "uniform":
        x = rng.uniform(0, 1, (n, 3))
    else:
        c = rng.uniform(0, 1, (4, 3))
        x = c[rng.integers(0, 4, n)] + rng.normal(0, 0.01, (n, 3))
    x = x.astype(np.float32)
    eu, ev, ew = port_emst(x)
    assert (eu >= 0).all() and (ev >= 0).all() and np.isfinite(ew).all()
    g = coo_matrix((np.ones(n - 1), (eu, ev)), shape=(n, n))
    assert connected_components(g, directed=False)[0] == 1   # N-1 edges: a tree
    np.testing.assert_allclose(
        ew, np.linalg.norm(x[eu].astype(np.float64) - x[ev], axis=1),
        rtol=4e-7)
    w = _prim_weight(x)
    assert abs(float(ew.astype(np.float64).sum()) - w) <= 1e-4 * w


def test_emst_inputs_run_where_they_live(monkeypatch):
    x = np.random.default_rng(16).uniform(0, 1, (30, 3)).astype(np.float32)
    got = emst(torch.from_numpy(x))
    assert got[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        emst(x)


# ---------------------------------------------------------------------------
# on the card (python -m pytest -m cuda tests/test_torch_emst.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_args(x, q, ql, leaf, dev, values="points"):
    """(index, the wrapper's positional arguments) on the card."""
    index = BVH(port_values(x, values, dev), policy=ExecutionPolicy(device=dev))
    t = index.tree
    arrays = [getattr(t, f) for f in ("node_lo", "node_hi", "rope",
                                      "left_child", "leaf_perm",
                                      "range_first", "range_last")]
    on = [torch.from_numpy(a).to(dev) for a in (q, ql, leaf)]
    return index, (*arrays, *on)


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["random", "one", "distinct", "minus_one"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 33, 256])
@pytest.mark.parametrize("values", ["points", "boxes"])
def test_kernel_matches_twin_on_the_card(cuda_device, values, k, labels):
    """The 3-D instance (node records) against its twin, every list
    bucket; over Points also the indexed points as queries in the leaf
    order. "minus_one" labels every other leaf -1, the MIXED label, which
    is excluded leaf by leaf."""
    x, q, ql, leaf = scene(3, "distinct" if labels == "minus_one" else labels,
                           seed=k)
    if labels == "minus_one":
        leaf = np.where(np.arange(len(leaf)) % 2 == 0, -1, leaf).astype(np.int32)
        ql = np.where(np.arange(Q) % 3 == 0, -1, ql).astype(np.int32)
    index, args = _card_args(x, q, ql, leaf, cuda_device, values)
    t = index.tree
    want = KT.bvh_traverse_knn_exclude_ref(*args, k=k)
    before = KT.bvh_traverse_knn_exclude.launches
    got = KT.bvh_traverse_knn_exclude(*args, k=k, records=t.records)
    torch.cuda.synchronize()
    assert KT.bvh_traverse_knn_exclude.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if values == "points":
        pts = index.values.coords
        self_args = (*args[:7], pts, args[9], args[9])
        order = KT.knn_order(pts, pts, t.leaf_perm)
        assert order is t.leaf_perm
        want = KT.bvh_traverse_knn_exclude_ref(*self_args, k=k)
        got = KT.bvh_traverse_knn_exclude(*self_args, k=k, records=t.records,
                                          order=order)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["uniform", "grid"])
@pytest.mark.parametrize("dim", [2, 5])
def test_flat_instance_matches_twin_on_the_card(cuda_device, dim, cloud):
    x, q, ql, leaf = scene(dim, "random", seed=dim, cloud=cloud)
    _, args = _card_args(x, q, ql, leaf, cuda_device)
    for k in (1, 4, 16):
        want = KT.bvh_traverse_knn_exclude_ref(*args, k=k)
        got = KT.bvh_traverse_knn_exclude(*args, k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_emst_on_the_card_takes_one_launch_a_round(cuda_device):
    """emst on the card equals emst on the CPU (the twin) exactly, with
    one kernel launch a Borůvka round and no loop walk."""
    x = np.random.default_rng(17).uniform(0, 1, (4096, 3)).astype(np.float32)
    want = port_emst(x)
    stats = {}
    before = KT.bvh_traverse_knn_exclude.launches
    calls = TT.knn_walk.calls
    got = port_emst(x, cuda_device, stats)
    assert KT.bvh_traverse_knn_exclude.launches - before == stats["rounds"]
    assert TT.knn_walk.calls == calls
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
