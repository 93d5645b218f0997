"""The spatial walk's 3-D records instance and the Karras ranges' bounded
searches (``csrc/bvh_traverse.cu::spatial_kernel3``, ``csrc/karras.cu``).

On the CPU: a Python transcription of the kernel's bounded Karras
searches (the step doubled until a probe fails, then a descending
power-of-two search; the split searched from the top bit of the range
length) is held to the port's twin ``karras_ranges_fused`` and to the JAX
package's ``karras_ranges_fused`` and Pallas kernel (interpret mode) on
edge keys: n = 2 .. 5 and 2^k +- 1, all-equal Morton codes (the index lane
decides), codes that differ only in ``hi`` or only in ``lo``, and a
seeded cloud of 2^12 points. Integers are compared exactly. Armed,
``REPRO_SANITIZE`` refuses a walk order that is not a permutation.

On the card (``-m cuda``): the spatial kernel against its twin
``bvh_traverse_spatial_ref``, counts and buffers bit for bit, for Points,
Boxes and Spheres queries over Points and Boxes values, with and without
a ``min_pos`` filter, a capacity below the largest count, N in {2, 3,
1000}, NaN coordinates, ``records=None``, a query order and a 2-D tree
(the flat instance); both walks refusing a repeated order under
``REPRO_SANITIZE``; and ``karras_ranges`` on the same edge keys.

The JAX package is imported inside the CPU tests only, so the file
collects on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import morton as TM
from repro_torch.kernels import bvh_traverse as TT
from repro_torch.kernels import lbvh_build as TK

SPATIAL_TREE = ("node_lo", "node_hi", "rope", "left_child", "range_last",
                "leaf_perm")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# edge keys: sorted (hi, lo) uint32 lanes; the index lane is the position
# ---------------------------------------------------------------------------

def _cloud_keys(n, seed):
    """The sorted Morton lanes of a seeded uniform cloud of n points."""
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (n, 3)).astype(np.float32))
    codes = TM.morton64(x, x.amin(0), x.amax(0))
    (hi, lo), _ = TM.sort_by_morton(codes, torch.arange(n))
    return hi.numpy(), lo.numpy()


def _sorted_lanes(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


def edge_keys(case):
    """(hi, lo) int64 arrays of uint32 values, sorted by (hi, lo)."""
    kind, n = case
    rng = np.random.default_rng(n)
    if kind == "cloud":
        return _cloud_keys(n, seed=n)
    if kind == "equal":
        return (np.full(n, 0x9E3779B9, np.int64),
                np.full(n, 0x7F4A7C15, np.int64))
    if kind == "hi_only":
        hi = rng.integers(0, 1 << 32, max(n // 2, 1), dtype=np.int64)
        return _sorted_lanes(hi[rng.integers(0, hi.shape[0], n)],
                             np.full(n, 0x12345678, np.int64))
    if kind == "lo_only":
        lo = rng.integers(0, 1 << 32, max(n // 2, 1), dtype=np.int64)
        return _sorted_lanes(np.full(n, 0xFFFFFFFF, np.int64),
                             lo[rng.integers(0, lo.shape[0], n)])
    return _cloud_keys(n, seed=100 + n)                     # "small"


KEY_CASES = ([("small", n) for n in (2, 3, 4, 5, 31, 33, 63, 65, 255, 257)]
             + [("equal", n) for n in (2, 3, 33, 257)]
             + [("hi_only", n) for n in (5, 65, 1000)]
             + [("lo_only", n) for n in (5, 65, 1000)]
             + [("cloud", 1 << 12)])


def _ids(case):
    return f"{case[0]}-{case[1]}"


# ---------------------------------------------------------------------------
# the kernel's searches, transcribed
# ---------------------------------------------------------------------------

def _clz32(x):
    return 32 - int(x).bit_length()


def karras_bounded(hi, lo, n):
    """(first, last, gamma, probes) of csrc/karras.cu's karras_kernel, one
    node at a time: the common-prefix length of the 96-bit keys (hi | lo |
    position), the range end by doubling then descending, the split from
    the top bit of the range length. `probes` counts delta calls."""
    hi = [int(v) for v in hi]
    lo = [int(v) for v in lo]
    first, last, gamma, probes = [], [], [], []
    for i in range(n - 1):
        calls = [0]

        def delta(j):
            calls[0] += 1
            if j < 0 or j > n - 1:
                return -1
            hx, lx = hi[i] ^ hi[j], lo[i] ^ lo[j]
            if hx:
                return _clz32(hx)
            if lx:
                return 32 + _clz32(lx)
            return 64 + _clz32(i ^ j)

        d_r, d_l = delta(i + 1), delta(i - 1)
        d = 1 if d_r > d_l else -1
        delta_min = d_l if d > 0 else d_r
        l_max = 2
        while delta(i + l_max * d) > delta_min:
            l_max <<= 1
        l, t = 0, l_max >> 1
        while t > 0:
            if delta(i + (l + t) * d) > delta_min:
                l += t
            t >>= 1
        j = i + l * d
        delta_node = delta(j)
        s, t = 0, (1 << (l.bit_length() - 1)) if l > 0 else 0
        while t > 0:
            if delta(i + (s + t) * d) > delta_node:
                s += t
            t >>= 1
        first.append(min(i, j))
        last.append(max(i, j))
        gamma.append(i + s * d + min(d, 0))
        probes.append(calls[0])
    return (np.array(first, np.int32), np.array(last, np.int32),
            np.array(gamma, np.int32), np.array(probes))


def _max_log2(n):
    return max((n - 1).bit_length(), 1)


def _torch_lanes(hi, lo, n, device="cpu"):
    return (torch.from_numpy(np.asarray(hi, np.int64)).to(device),
            torch.from_numpy(np.asarray(lo, np.int64)).to(device),
            torch.arange(n, dtype=torch.int64, device=device))


@pytest.mark.parametrize("case", KEY_CASES, ids=_ids)
def test_bounded_searches_equal_both_twins(case):
    """The bounded searches give the integers of the port's twin and of
    the reference's fused search and Pallas kernel (interpret mode)."""
    import jax.numpy as jnp
    from repro.kernels import lbvh_build as JK
    hi, lo = edge_keys(case)
    n = hi.shape[0]
    ml2 = _max_log2(n)
    first, last, gamma, _ = karras_bounded(hi, lo, n)
    twin = TK.karras_ranges(*_torch_lanes(hi, lo, n), n, ml2)
    jkeys = (jnp.asarray(hi.astype(np.uint32)), jnp.asarray(lo.astype(np.uint32)),
             jnp.arange(n, dtype=jnp.uint32))
    fused = JK.karras_ranges_fused(*jkeys, n, ml2)
    refs = [fused]
    if n <= 1024:
        refs.append(JK.karras_ranges_pallas(*jkeys, n, ml2, interpret=True))
    for got, t in zip((first, last, gamma), twin):
        np.testing.assert_array_equal(got, t.numpy())
    for ref in refs:
        for got, r in zip((first, last, gamma), ref):
            np.testing.assert_array_equal(got, np.asarray(r))


@pytest.mark.parametrize("case", KEY_CASES, ids=_ids)
def test_bounded_probe_count(case):
    """Node i makes 3 + 3 (floor(log2 l) + 1) probes for a range of length
    l = last - first (the count chip_smoke.py's second Karras bound
    uses); on the mean fewer than the twin's fixed 2 (max_log2 + 1) + 3,
    though a node near the root makes more."""
    hi, lo = edge_keys(case)
    n = hi.shape[0]
    first, last, _, probes = karras_bounded(hi, lo, n)
    length = (last - first).astype(np.int64)
    assert (length >= 1).all()
    want = 3 + 3 * (np.floor(np.log2(length)).astype(np.int64) + 1)
    np.testing.assert_array_equal(probes, want)
    assert probes.mean() < 2 * (_max_log2(n) + 1) + 3


def test_equal_codes_split_by_position():
    """All-equal Morton codes: the index lane alone shapes the tree, the
    root covers every leaf and splits where the position's top bit
    turns."""
    n = 33
    hi, lo = edge_keys(("equal", n))
    first, last, gamma, _ = karras_bounded(hi, lo, n)
    assert (first[0], last[0], gamma[0]) == (0, n - 1, 31)


# ---------------------------------------------------------------------------
# the spatial walk's query order
# ---------------------------------------------------------------------------

def _self_index(n=400, seed=5):
    from repro_torch import BVH, EngineConfig, ExecutionPolicy, QueryEngine
    x = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    policy = ExecutionPolicy(device="cpu",
                             engine=QueryEngine(EngineConfig(force="kernel")))
    return x, BVH(TG.Points(torch.from_numpy(x)), policy=policy)


def test_self_query_order_is_the_leaf_permutation():
    """Spheres centred on the indexed points (the self CSR query, DBSCAN's
    neighbourhoods) walk in the tree's leaf order, a permutation of the
    queries; spheres centred elsewhere keep the caller's order."""
    from repro_torch.core import predicates as TP
    from repro_torch.kernels import bvh_callback as TC
    x, index = _self_index()
    n = x.shape[0]
    r = torch.full((n,), 0.08)
    perm = index.tree.leaf_perm
    own = TP.intersects(TG.Spheres(index.values.coords, r))
    order = TC.query_order(own, index.values, perm)
    assert order is perm and order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(n))
    other = TP.intersects(TG.Spheres(index.values.coords.clone(), r))
    assert TC.query_order(other, index.values, perm) is None


def test_self_csr_query_matches_reference():
    """BVH.query(intersects(Spheres(points, r))) over the points themselves
    on the CPU: the kernel route's CSR equals the JAX package's as a set
    per query."""
    import jax.numpy as jnp
    from test_torch_parity import ROUTE_MAP, assert_csr_equal_sets
    from repro.core import BVH as JBVH
    from repro.core import geometry as JG
    from repro.core import predicates as JP
    from repro.core.engine import EngineConfig as JEngineConfig
    from repro.core.engine import QueryEngine as JQueryEngine
    from repro_torch.core import predicates as TP
    x, index = _self_index()
    n = x.shape[0]
    r = np.full((n,), 0.08, np.float32)
    jengine = JQueryEngine(JEngineConfig(force=ROUTE_MAP["kernel"]))
    jres = JBVH(JG.Points(jnp.asarray(x)), engine=jengine).query(
        JP.intersects(JG.Spheres(jnp.asarray(x), jnp.asarray(r))))
    tres = index.query(TP.intersects(TG.Spheres(index.values.coords,
                                                torch.from_numpy(r))))
    assert_csr_equal_sets(tres.offsets, tres.indices, jres.offsets,
                          jres.indices)
    assert int(tres.offsets[-1]) > n                   # beyond self matches


BAD_ORDERS = {"repeated": [0, 1, 1, 3], "outside": [0, 1, 2, 4],
              "negative": [0, -1, 2, 3]}


@pytest.mark.parametrize("kind", sorted(BAD_ORDERS))
def test_sanitize_refuses_an_order_that_is_not_a_permutation(monkeypatch,
                                                              kind):
    """Armed, REPRO_SANITIZE refuses a walk order that leaves a row out
    (its row would stay unwritten) and passes a permutation; unarmed it
    reads nothing."""
    from repro_torch.kernels import sanitize as S
    bad = torch.tensor(BAD_ORDERS[kind], dtype=torch.int32)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    S.check_order(bad, q=4, kernel="k")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(AssertionError, match="order"):
        S.check_order(bad, q=4, kernel="k")
    S.check_order(torch.tensor([2, 0, 3, 1], dtype=torch.int32), q=4,
                  kernel="k")
    S.check_order(None, q=4, kernel="k")


# ---------------------------------------------------------------------------
# on the card (python -m pytest -m cuda tests/test_torch_spatial_karras.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", KEY_CASES, ids=_ids)
def test_karras_kernel_matches_twin_on_the_card(cuda_device, case):
    hi, lo = edge_keys(case)
    n = hi.shape[0]
    keys = _torch_lanes(hi, lo, n, cuda_device)
    before = TK.karras_ranges.launches
    got = TK.karras_ranges(*keys, n, _max_log2(n))
    want = TK.karras_ranges_fused(*keys, n, _max_log2(n))
    torch.cuda.synchronize()
    assert TK.karras_ranges.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)


def _values(kind, n, dim, rng, nan=False):
    lo = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    if n > 4:
        lo[n // 3] = lo[0]                                # duplicate leaves
    hi = lo if kind == "points" else (lo + rng.uniform(
        0, 0.08, (n, dim))).astype(np.float32)
    if nan and n > 8:
        hi = hi.copy()
        hi[5, 0] = np.nan
    return torch.from_numpy(lo), torch.from_numpy(hi)


def _queries(kind, q, dim, rng, centres, nan=False):
    c = rng.uniform(-0.05, 1.05, (q, dim)).astype(np.float32)
    c[: q // 4] = centres[rng.integers(0, centres.shape[0], q // 4)]
    r = np.zeros(q, np.float32)
    if kind == "points":
        lo = hi = c
    elif kind == "boxes":
        lo, hi = c, (c + rng.uniform(0, 0.2, (q, dim))).astype(np.float32)
    else:
        lo = hi = c
        r = rng.uniform(0, 0.15, q).astype(np.float32)
    if nan:
        lo = lo.copy()
        lo[1, 0] = np.nan
        r[2] = np.nan
    return (torch.from_numpy(np.ascontiguousarray(lo)),
            torch.from_numpy(np.ascontiguousarray(hi)), torch.from_numpy(r))


def _spatial_case(dev, vkind, qkind, n, dim=3, q=200, nan=False, seed=0):
    rng = np.random.default_rng(seed)
    vlo, vhi = _values(vkind, n, dim, rng, nan)
    tree = TL.build(TG.Boxes(vlo, vhi)).to(dev)
    qlo, qhi, r = _queries(qkind, q, dim, rng, vlo.numpy(), nan)
    return tree, [a.to(dev) for a in (qlo, qhi, r)]


def _assert_spatial(tree, qargs, cap, fine, min_pos=None, **kw):
    args = [getattr(tree, f) for f in SPATIAL_TREE] + qargs
    want = TT.bvh_traverse_spatial_ref(*args, capacity=cap, fine_sqrt=fine,
                                       min_pos=min_pos)
    before = TT.bvh_traverse_spatial.launches
    got = TT.bvh_traverse_spatial(*args, capacity=cap, fine_sqrt=fine,
                                  min_pos=min_pos, **kw)
    torch.cuda.synchronize()
    assert TT.bvh_traverse_spatial.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("n", [2, 3, 1000])
@pytest.mark.parametrize("qkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_spatial_records_instance_matches_twin(cuda_device, vkind, qkind, n,
                                               filtered):
    """The 3-D instance over the tree's records, bit for bit, with a
    capacity below the largest count (the overflow) and without, and with
    a min_pos filter (the range_last read) or none."""
    tree, qargs = _spatial_case(cuda_device, vkind, qkind, n, seed=n)
    min_pos = None
    if filtered:
        g = torch.Generator().manual_seed(n)
        min_pos = torch.randint(-1, n, (qargs[0].shape[0],), generator=g,
                                dtype=torch.int32).to(cuda_device)
    fine = vkind == "points"
    counts, _ = _assert_spatial(tree, qargs, 64, fine, min_pos,
                                records=tree.records)
    top = int(counts.max())
    if top > 1:
        _assert_spatial(tree, qargs, top - 1, fine, min_pos,
                        records=tree.records)


@pytest.mark.cuda
@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_spatial_nan_coordinates(cuda_device, vkind):
    """NaN in a query coordinate, a radius and a value's box: no match
    through a NaN test, in the kernel as in the twin."""
    for qkind in ("points", "boxes", "spheres"):
        tree, qargs = _spatial_case(cuda_device, vkind, qkind, 1000,
                                    nan=True, seed=7)
        _assert_spatial(tree, qargs, 16, vkind == "points",
                        records=tree.records)


@pytest.mark.cuda
def test_spatial_without_records_and_with_an_order(cuda_device):
    """records=None (the wrapper packs them) and a query order leave every
    count and buffer as the twin's."""
    tree, qargs = _spatial_case(cuda_device, "points", "spheres", 1000, q=500)
    _assert_spatial(tree, qargs, 32, True)
    g = torch.Generator().manual_seed(3)
    order = torch.randperm(500, generator=g).to(torch.int32).to(cuda_device)
    _assert_spatial(tree, qargs, 32, True, records=tree.records, order=order)
    _assert_spatial(tree, qargs, 32, True, order=order)


@pytest.mark.cuda
def test_spatial_and_knn_refuse_a_repeated_order_under_sanitize(
        cuda_device, monkeypatch):
    """Armed, both walks refuse an order with a repeated row before they
    launch."""
    tree, qargs = _spatial_case(cuda_device, "points", "spheres", 1000, q=500)
    order = torch.arange(500, dtype=torch.int32, device=cuda_device)
    order[7] = 6
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(AssertionError, match="not a permutation"):
        TT.bvh_traverse_spatial(*(getattr(tree, f) for f in SPATIAL_TREE),
                                *qargs, capacity=4, records=tree.records,
                                order=order)
    with pytest.raises(AssertionError, match="not a permutation"):
        TT.bvh_traverse_knn(tree.node_lo, tree.node_hi, tree.rope,
                            tree.left_child, tree.leaf_perm, qargs[0], k=4,
                            records=tree.records, order=order)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 5])
def test_spatial_flat_instance_in_other_dims(cuda_device, dim):
    """A 2-D (and 5-D) tree takes the flat instance; it refuses an order."""
    tree, qargs = _spatial_case(cuda_device, "boxes", "spheres", 1000,
                                dim=dim, seed=dim)
    _assert_spatial(tree, qargs, 24, False)
    order = torch.arange(qargs[0].shape[0], dtype=torch.int32,
                         device=cuda_device)
    with pytest.raises(ValueError, match="3-D only"):
        TT.bvh_traverse_spatial(*(getattr(tree, f) for f in SPATIAL_TREE),
                                *qargs, capacity=4, order=order)


@pytest.mark.cuda
def test_engine_hands_the_spatial_kernel_records_and_the_leaf_order(
        cuda_device, monkeypatch):
    """On the card the engine passes the tree's kept records to every 3-D
    spatial call and the leaf order to a self query; CSR results equal
    the CPU index's."""
    from repro_torch import BVH, EngineConfig, ExecutionPolicy, QueryEngine
    from repro_torch.core import engine as TE
    from repro_torch.core import predicates as TP
    calls = []
    real = TE.bvh_traverse_spatial

    def spy(*a, **kw):
        calls.append((kw.get("records"), kw.get("order")))
        return real(*a, **kw)

    monkeypatch.setattr(TE, "bvh_traverse_spatial", spy)
    x, cpu_index = _self_index(n=3000)
    policy = ExecutionPolicy(device=cuda_device,
                             engine=QueryEngine(EngineConfig(force="kernel")))
    index = BVH(TG.Points(torch.from_numpy(x).to(cuda_device)),
                policy=policy)
    r = torch.full((3000,), 0.05, device=cuda_device)
    for own in (True, False):
        centres = (index.values.coords if own
                   else torch.flip(index.values.coords, [0]))
        got = index.query(TP.intersects(TG.Spheres(centres, r)))
        torch.cuda.synchronize()
        assert len(calls) == 2
        for rec, order in calls:
            assert rec is index.tree.records
            assert order is (index.tree.leaf_perm if own else None)
        calls.clear()
        want = cpu_index.query(TP.intersects(TG.Spheres(centres.cpu(),
                                                        r.cpu())))
        assert calls == [(None, None)] * 2             # the CPU twin's
        calls.clear()
        assert torch.equal(got.offsets.cpu(), want.offsets)
        assert torch.equal(got.indices.cpu(), want.indices)
