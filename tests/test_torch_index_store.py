"""The port's ``IndexStore`` and ``lbvh.refit_with_quality`` against the
JAX reference on the CPU, and the reference's pin / trim / hammer cases
(``tests/test_index_store_concurrency.py``) on the port.

Compared at these tolerances, on seeded numpy inputs:

  * the same build / update sequence on both stores gives the same
    actions ("build", "refit", "rebuild"), versions, refit counts and
    leaf counts, and SAH costs within 1e-5 relative (the node boxes are
    the reference's bit for bit; the surface sums add in another order).
    The drifts are chosen far from the rebuild threshold (1.5): a shift
    of 1e-3 (degradation about 1.0) and a shuffle of the points (far
    above it);
  * ``refit_with_quality`` equals the port's ``refit`` + ``sah_cost``
    exactly, and the reference's node boxes bit for bit and its SAH cost
    to 1e-5 relative.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.service as RS
from repro.core import geometry as RG
from repro.core import lbvh as RL
from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core.bvh import BVH
from repro_torch.core.index import ExecutionPolicy
from repro_torch.service import IndexStore

CPU = "cpu"
N = 32
DIM = 3
SAH_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cloud(base, tag):
    return TG.Points(torch.from_numpy(base + np.float32(tag)))


def _store(**kw):
    return IndexStore(device=CPU, **kw)


# ---------------------------------------------------------------------------
# the same sequence on both stores
# ---------------------------------------------------------------------------

def _sequence(n, dim, seed):
    """(label, coordinates) updates after the build: a small shift
    (refit), a shuffle (rebuild by quality), a small shift again (refit),
    a new leaf count (rebuild)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    shuffled = base[rng.permutation(n)][:, ::-1].copy()
    return base, [("shift", base + np.float32(1e-3)),
                  ("shuffle", shuffled),
                  ("shift", shuffled + np.float32(1e-3)),
                  ("resize", rng.uniform(0, 1, (n + 37, dim))
                   .astype(np.float32))]


@pytest.mark.parametrize("n,dim", [(500, 3)])
def test_store_sequence_matches_the_reference(n, dim):
    base, updates = _sequence(n, dim, n)
    ref = RS.IndexStore(rebuild_threshold=1.5)
    port = _store(rebuild_threshold=1.5)
    got = [port.build("pts", TG.Points(torch.from_numpy(base)))]
    want = [ref.build("pts", RG.Points(jnp.asarray(base)))]
    for _, coords in updates:
        got.append(port.update("pts", TG.Points(torch.from_numpy(coords))))
        want.append(ref.update("pts", RG.Points(jnp.asarray(coords))))
    assert [v.action for v in want] == \
        ["build", "refit", "rebuild", "refit", "rebuild"]
    for g, w in zip(got, want):
        assert (g.name, g.version, g.action, g.refits_since_build,
                g.bvh.size(), g.dim) == \
            (w.name, w.version, w.action, w.refits_since_build,
             w.bvh.size(), w.dim)
        assert g.sah == pytest.approx(w.sah, rel=SAH_RTOL)
        assert g.sah_built == pytest.approx(w.sah_built, rel=SAH_RTOL)
    # far from the threshold either way: the shift refits at about 1.0,
    # the shuffle's refit would cost far above 1.5 x the build's
    assert got[1].degradation < 1.1
    shuffled = torch.from_numpy(updates[1][1])
    _, sah = TL.refit_with_quality(got[1].bvh.tree,
                                   TG.Boxes(shuffled, shuffled))
    assert float(sah) > 3 * got[1].sah_built
    assert port.get("pts").version == ref.get("pts").version == 5


def test_refit_keeps_leaf_count_and_n_change_rebuilds():
    base = np.random.default_rng(3).uniform(0, 1, (64, DIM)).astype(np.float32)
    store = _store()
    v1 = store.build("pts", _cloud(base, 0))
    v2 = store.update("pts", _cloud(base, 0.001))
    assert (v2.action, v2.version, v2.refits_since_build) == ("refit", 2, 1)
    assert v2.bvh.tree.leaf_perm is v1.bvh.tree.leaf_perm   # topology kept
    v3 = store.update("pts", TG.Points(torch.from_numpy(base[:40])))
    assert (v3.action, v3.bvh.size()) == ("rebuild", 40)
    assert store.names() == ["pts"]


# ---------------------------------------------------------------------------
# refit_with_quality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dim", [(2, 3), (257, 3), (300, 5)])
def test_refit_with_quality_matches_refit_and_the_reference(n, dim):
    rng = np.random.default_rng(n + dim)
    pts = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    moved = pts + rng.normal(0, 0.01, (n, dim)).astype(np.float32)
    tree = TL.build(TG.Boxes(torch.from_numpy(pts), torch.from_numpy(pts)))
    boxes = TG.Boxes(torch.from_numpy(moved), torch.from_numpy(moved))
    got, sah = TL.refit_with_quality(tree, boxes)
    plain = TL.refit(tree, boxes)
    for f in TL.FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    assert sah.dim() == 0 and float(sah) == float(TL.sah_cost(plain))

    rtree = RL.build(RG.Boxes(jnp.asarray(pts), jnp.asarray(pts)))
    rgot, rsah = RL.refit_with_quality(
        rtree, RG.Boxes(jnp.asarray(moved), jnp.asarray(moved)))
    assert np.array_equal(got.node_lo.numpy(), np.asarray(rgot.node_lo))
    assert np.array_equal(got.node_hi.numpy(), np.asarray(rgot.node_hi))
    assert float(sah) == pytest.approx(float(rsah), rel=SAH_RTOL)


def test_from_tree_keeps_a_tree_on_its_device():
    """A refit swap wraps the refit tree as it is, its kept node records
    with it."""
    pts = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (300, DIM)).astype(np.float32))
    pol = ExecutionPolicy(device=CPU)
    tree = BVH(TG.Points(pts), policy=pol).tree
    moved = TG.Points(pts + 0.001)
    new, _ = TL.refit_with_quality(tree, TG.Boxes(moved.coords, moved.coords))
    assert BVH.from_tree(moved, new, policy=pol).tree is new


# ---------------------------------------------------------------------------
# the reference's concurrency cases on the port
# ---------------------------------------------------------------------------

def test_pinned_version_survives_history_eviction():
    base = np.random.default_rng(0).uniform(0, 1, (N, DIM)).astype(np.float32)
    store = _store(keep_versions=1)
    v1 = store.build("pts", _cloud(base, 0))
    pinned = store.pin("pts")
    assert pinned is v1
    for tag in (1, 2, 3):
        store.update("pts", _cloud(base, tag))
    assert store.get("pts").version == 4
    assert store.get("pts", 1) is v1            # the pin holds it
    store.release(pinned)
    with pytest.raises(KeyError):
        store.get("pts", 1)
    assert store.get("pts").version == 4


def test_double_pin_released_independently():
    base = np.zeros((N, DIM), np.float32)
    store = _store(keep_versions=1)
    store.build("pts", _cloud(base, 0))
    a, b = store.pin("pts"), store.pin("pts")
    store.update("pts", _cloud(base, 1))
    store.release(a)
    assert store.get("pts", 1) is b
    store.release(b)
    with pytest.raises(KeyError):
        store.get("pts", 1)


def test_hammered_swaps_never_tear_and_pins_survive():
    base = np.random.default_rng(1).uniform(0, 1, (N, DIM)).astype(np.float32)
    store = _store(keep_versions=1)
    tags = {}
    tag_lock = threading.Lock()
    writer_done = threading.Event()
    errors = []

    entry0 = store.build("pts", _cloud(base, 0))
    with tag_lock:
        tags[entry0.version] = 0

    def writer():
        try:
            for tag in range(1, 26):
                if tag % 5 == 0:     # the rebuild path too
                    entry = store.build("pts", _cloud(base, tag))
                else:                # same leaf count -> refit swap
                    entry = store.update("pts", _cloud(base, tag))
                with tag_lock:
                    tags[entry.version] = tag
        except Exception as err:
            errors.append(err)
        finally:
            writer_done.set()

    def reader():
        try:
            last_version = 0
            while not writer_done.is_set():
                entry = store.pin("pts")
                try:
                    assert entry.version >= last_version
                    last_version = entry.version
                    assert store.get("pts", entry.version) is entry
                    tag = None
                    for _ in range(2000):
                        with tag_lock:
                            tag = tags.get(entry.version)
                        if tag is not None or writer_done.is_set():
                            break
                        time.sleep(0.001)
                    if tag is None:
                        with tag_lock:
                            tag = tags.get(entry.version)
                    assert tag is not None, "published version missing a tag"
                    coords = entry.bvh.values.coords.numpy()
                    assert np.array_equal(coords, base + np.float32(tag))
                    # the tree bounds the values it was published with
                    t = entry.bvh.tree
                    assert bool((t.node_lo[0] <= entry.bvh.values.coords)
                                .all())
                finally:
                    store.release(entry)
        except Exception as err:
            errors.append(err)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    wt = threading.Thread(target=writer)
    for t in readers + [wt]:
        t.start()
    for t in readers + [wt]:
        t.join(120)
    assert not any(t.is_alive() for t in readers + [wt])
    assert not errors, errors
    assert store.get("pts").version == 26
    assert len(store._history["pts"]) == 1


def test_pinned_context_manager_balances_on_exception():
    base = np.zeros((N, DIM), np.float32)
    store = _store(keep_versions=1)
    store.build("pts", _cloud(base, 0))
    with pytest.raises(RuntimeError):
        with store.pinned("pts") as entry:
            assert entry.version == 1
            raise RuntimeError("dispatch blew up")
    assert store._pins == {}
    store.update("pts", _cloud(base, 1))
    with pytest.raises(KeyError):
        store.get("pts", 1)


def test_gated_trim_interleaving_leaks_no_pins():
    base = np.random.default_rng(7).uniform(0, 1, (N, DIM)).astype(np.float32)
    store = _store(keep_versions=1)
    store.build("pts", _cloud(base, 0))
    pinned, swapped = threading.Event(), threading.Event()
    errors = []

    def scheduler():
        try:
            with store.pinned("pts") as entry:
                assert entry.version == 1
                pinned.set()
                assert swapped.wait(60), "maintenance never swapped"
                assert store.get("pts", 1) is entry
                coords = entry.bvh.values.coords.numpy()
                assert np.array_equal(coords, base + np.float32(0))
        except Exception as err:
            errors.append(err)

    def maintenance():
        try:
            assert pinned.wait(60), "scheduler never pinned"
            for tag in (1, 2, 3):
                store.update("pts", _cloud(base, tag))
            assert sorted(store._history["pts"]) == [1, 4]
            swapped.set()
        except Exception as err:
            errors.append(err)
            swapped.set()

    ts = [threading.Thread(target=scheduler),
          threading.Thread(target=maintenance)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert store._pins == {}
    with pytest.raises(KeyError):
        store.get("pts", 1)
    assert sorted(store._history["pts"]) == [4]


def test_query_server_dispatch_pins_against_concurrent_eviction(monkeypatch):
    from repro_torch.service import QueryServer, knn_request
    from repro_torch.service import server as SRV

    base = np.random.default_rng(9).uniform(0, 1, (N, DIM)).astype(np.float32)
    store = _store(keep_versions=1)
    srv = QueryServer(store=store)
    srv.create_index("pts", _cloud(base, 0))

    real = SRV.execute_group
    observed = {}

    def racing_execute(engine, config, entry, group):
        for tag in (1, 2, 3):                   # maintenance mid-dispatch
            store.update("pts", _cloud(base, tag))
        observed["resolvable"] = store.get("pts", entry.version) is entry
        observed["version"] = entry.version
        return real(engine, config, entry, group)

    monkeypatch.setattr(SRV, "execute_group", racing_execute)
    q = np.zeros((4, DIM), np.float32)
    (resp,) = srv.handle([knn_request(q, 2, "pts")])
    assert observed == {"resolvable": True, "version": 1}
    assert resp.stats.index_version == 1
    assert store._pins == {}
    with pytest.raises(KeyError):
        store.get("pts", 1)
