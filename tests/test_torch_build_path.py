"""The LBVH build on the card: the Morton step (``csrc/morton.cu``'s build
entry, ``kernels.morton.morton_key``) and the build's tail
(``csrc/lbvh_tail.cu``, ``kernels.lbvh_build.lbvh_tail`` / ``lbvh_refit``).

On the CPU the twins are held to the JAX package on seeded numpy boxes,
with tolerance 0:
  * the build key (the centroids' 32- or 64-bit Morton codes in their own
    scene, as one signed int64) and its stable sort permutation against
    ``repro.core.morton``;
  * every LBVH field of ``core.lbvh.build`` against ``repro.core.lbvh.build``
    with ``refit="rmq"`` and ``refit="iterative"``, ``refit`` against
    ``repro.core.lbvh.refit``, and the node records against the fields;
over N = 2, 3, 1000 and non-powers of two, dims 1-6 and 10, 32- and
64-bit codes, duplicate boxes, and boxes holding NaN, +-inf and zeros of
both signs. Floats are compared bit for bit, NaN by position (torch's
minimum returns an all-ones NaN, XLA an operand: the payloads are not a
result). The zeros are settled as XLA's minimum and maximum order them,
-0 below +0 in either operand order: a node's low corner is -0 when a leaf
below it has -0 there, its high corner +0 when one has +0.

On the card (``-m cuda``): the card's build and refit against the CPU
twins, node for node and record for record, with one Morton launch and
one tail launch a build (one tail launch a refit), and neither
``core.morton._interleave`` nor ``kernels.lbvh_build.aabb_rmq`` run; the
key kernel at every instance (dims 1-6 and the generic one, 32 and 64
bits, unaligned rows); the records kept by the build, and packed at first
use for a tree moved to the card.

The JAX package is imported inside the CPU tests only, so the file
collects on a machine without JAX.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import morton as TM
from repro_torch.kernels import bvh_traverse as TT
from repro_torch.kernels import lbvh_build as TK
from repro_torch.kernels import morton as KM

KINDS = ("uniform", "points", "duplicates", "nan", "inf", "zeros")
SHAPES = [(2, 3), (3, 1), (3, 3), (1000, 3), (777, 2), (1000, 1), (513, 4),
          (300, 5), (300, 6), (200, 10)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def boxes(n, dim, kind, seed=0):
    """(lo, hi) (n, dim) float32 numpy boxes of one kind."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    hi = (lo + rng.uniform(0, 0.05, (n, dim))).astype(np.float32)
    if kind == "points":
        hi = lo.copy()
    elif kind == "duplicates":
        rows = rng.integers(0, max(n // 4, 1), n)
        lo, hi = lo[rows], hi[rows]
    elif kind == "nan":
        lo[n // 2, 0] = np.nan                  # a NaN centroid
        hi[-1, dim - 1] = np.nan
    elif kind == "inf":
        lo[0, 0] = -np.inf
        hi[n // 2, dim - 1] = np.inf
    elif kind == "zeros":
        # every coordinate -0, +0 or one of a few values, both corners:
        # ranges mix the two zeros in their low and high corners
        vals = np.array([-0.0, 0.0, -0.0, 0.0, 0.5, -0.5], np.float32)
        lo = vals[rng.integers(0, vals.size, (n, dim))]
        hi = np.where(rng.uniform(size=(n, dim)) < 0.5, lo,
                      vals[rng.integers(0, vals.size, (n, dim))])
        hi = np.maximum(lo, hi).astype(np.float32)
    return np.ascontiguousarray(lo), np.ascontiguousarray(hi)


def same(a, b, what=""):
    """a and b equal bit for bit, NaN by position."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f"{what}: NaN places"
        a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
    assert torch.equal(a, b), what


def same_records(a, b, what="records"):
    """(2N-1, 8) records equal: the box columns as floats (NaN by
    position), rope and link as integers."""
    f = [0, 1, 2, 4, 5, 6]
    same(a[:, f].view(torch.float32), b[:, f].view(torch.float32), what)
    same(a[:, [3, 7]], b[:, [3, 7]], what)


def same_tree(a, b):
    for f in TL.FIELDS:
        same(getattr(a, f), getattr(b, f), f)


def _ref():
    """The JAX package's modules (imported here only)."""
    return (importlib.import_module("repro.core.geometry"),
            importlib.import_module("repro.core.lbvh"),
            importlib.import_module("repro.core.morton"))


def _ref_build(lo, hi, bits, refit="rmq"):
    import jax.numpy as jnp
    JG, JL, _ = _ref()
    return JL.build(JG.Boxes(jnp.asarray(lo), jnp.asarray(hi)), bits=bits,
                    refit=refit)


def _np(x):
    """A JAX array as a CPU tensor."""
    return torch.from_numpy(np.array(x))


def _torch_boxes(lo, hi, dev="cpu"):
    return TG.Boxes(torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))


# ---------------------------------------------------------------------------
# CPU: the twins against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("n,dim", SHAPES)
def test_build_key_and_permutation_match_reference(n, dim, bits, kind):
    import jax.numpy as jnp
    _, _, JM = _ref()
    lo, hi = boxes(n, dim, kind, seed=n + dim)
    c = 0.5 * (jnp.asarray(lo) + jnp.asarray(hi))
    s_lo, s_hi = c.min(0), c.max(0)
    if bits == 64:
        jhi, jlo = JM.morton64(c, s_lo, s_hi)
    else:
        jlo = JM.morton32(c, s_lo, s_hi)
        jhi = jnp.zeros_like(jlo)
    want = ((np.asarray(jhi).astype(np.int64) - (1 << 31)) << 32) + \
        np.asarray(jlo).astype(np.int64)
    key = KM.morton_key(torch.from_numpy(lo), torch.from_numpy(hi), bits)
    np.testing.assert_array_equal(key.numpy(), want)
    codes = (jhi, jlo) if bits == 64 else jlo
    _, jperm = JM.sort_by_morton(codes, jnp.arange(n, dtype=jnp.int32))
    np.testing.assert_array_equal(torch.sort(key, stable=True).indices.numpy(),
                                  np.asarray(jperm))
    # the sorted keys give the reference's 96-bit lanes back
    (jhs, jls), _ = JM.sort_by_morton(
        (jhi, jlo), jnp.arange(n, dtype=jnp.int32))
    lanes = TM.key_lanes(torch.sort(key, stable=True).values)
    for got, ref in zip(lanes, JM.combined_delta_key((jhs, jls), n)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("n,dim", SHAPES)
def test_build_fields_and_records_match_reference(n, dim, bits, kind):
    lo, hi = boxes(n, dim, kind, seed=3 * n + dim)
    tree = TL.build(_torch_boxes(lo, hi), bits=bits)
    jt = _ref_build(lo, hi, bits)
    for f in TL.FIELDS:
        same(getattr(tree, f), _np(getattr(jt, f)), f)
    if dim == 3:
        assert "records" in tree.__dict__           # made by the build
        same_records(tree.records, TT.pack_nodes(
            tree.node_lo, tree.node_hi, tree.rope, tree.left_child,
            tree.leaf_perm))
    else:
        assert tree.records is None


@pytest.mark.parametrize("kind", ["uniform", "nan", "inf", "zeros"])
@pytest.mark.parametrize("n,dim", [(2, 3), (3, 2), (1000, 3), (300, 6)])
def test_build_matches_the_iterative_refit(n, dim, kind):
    """The reference's bottom-up refit gives the same floats as its sparse
    table, zeros and NaN included: the order of combining is no result."""
    lo, hi = boxes(n, dim, kind, seed=5 * n + dim)
    tree = TL.build(_torch_boxes(lo, hi))
    jt = _ref_build(lo, hi, 64, refit="iterative")
    for f in TL.FIELDS:
        same(getattr(tree, f), _np(getattr(jt, f)), f)


@pytest.mark.parametrize("kind", ["uniform", "nan", "zeros"])
@pytest.mark.parametrize("n,dim", [(2, 3), (1000, 3), (777, 2)])
def test_refit_matches_reference(n, dim, kind):
    import jax.numpy as jnp
    JG, JL, _ = _ref()
    lo, hi = boxes(n, dim, "uniform", seed=n)
    tree = TL.build(_torch_boxes(lo, hi))
    jt = _ref_build(lo, hi, 64)
    mlo, mhi = boxes(n, dim, kind, seed=n + 1)
    moved = TL.refit(tree, _torch_boxes(mlo, mhi))
    jr = JL.refit(jt, JG.Boxes(jnp.asarray(mlo), jnp.asarray(mhi)))
    for f in TL.FIELDS:
        same(getattr(moved, f), _np(getattr(jr, f)),
             f)
    if dim == 3:
        assert "records" in moved.__dict__
        same_records(moved.records, TT.pack_nodes(
            moved.node_lo, moved.node_hi, moved.rope, moved.left_child,
            moved.leaf_perm))


def test_zeros_order_as_the_reference():
    """Two leaves at -0 and +0: the root's low corner is -0 and its high
    corner +0 in the reference, in the twin (``aabb_rmq`` settles the tie),
    whichever leaf comes first; ``torch.minimum`` alone returns either
    operand on such a tie."""
    for order in ([-0.0, 0.0], [0.0, -0.0]):
        x = np.array(order, np.float32)[:, None]
        jt = _ref_build(x, x, 64)
        tree = TL.build(_torch_boxes(x, x))
        for t in (tree, jt):
            root_lo, root_hi = _np(t.node_lo)[0], _np(t.node_hi)[0]
            assert bool(torch.signbit(root_lo).all())
            assert not bool(torch.signbit(root_hi).any())
    a, b = torch.tensor([-0.0, 0.0]), torch.tensor([0.0, -0.0])
    assert torch.signbit(TK._min_zeros(a, b)).all()
    assert torch.signbit(TK._min_zeros(b, a)).all()


def test_build_runs_each_step_once(monkeypatch):
    """One key, one sort, one Karras call and one tail call a build; the
    tree keeps the tail's records."""
    calls = []

    def spy(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(KM, "morton_key", spy("key", KM.morton_key))
    monkeypatch.setattr(TK, "karras_ranges", spy("karras", TK.karras_ranges))
    monkeypatch.setattr(TK, "lbvh_tail", spy("tail", TK.lbvh_tail))
    monkeypatch.setattr(TK, "lbvh_refit", spy("refit", TK.lbvh_refit))
    lo, hi = boxes(100, 3, "uniform")
    tree = TL.build(_torch_boxes(lo, hi))
    TL.refit(tree, _torch_boxes(hi, hi))
    assert calls == ["key", "karras", "tail", "refit"]


def test_moved_tree_packs_records_at_first_use():
    lo, hi = boxes(50, 3, "uniform")
    tree = TL.build(_torch_boxes(lo, hi))
    moved = tree.to("cpu")
    assert "records" not in moved.__dict__
    same_records(moved.records, tree.records)


def test_tail_wrappers_refuse_other_devices_and_count_only_launches():
    lo, hi = boxes(40, 3, "uniform")
    tree = TL.build(_torch_boxes(lo, hi))
    t = {f: getattr(tree, f) for f in TL.FIELDS}
    before = (KM.morton64.launches, TK.lbvh_tail.launches)
    key = KM.morton_key(*(torch.from_numpy(a) for a in (lo, hi)))
    TL.refit(tree, _torch_boxes(lo, hi))
    assert (KM.morton64.launches, TK.lbvh_tail.launches) == before
    m = {f: v.to("meta") for f, v in t.items()}
    with pytest.raises(ValueError, match="no kernel"):
        KM.morton_key(m["node_lo"], m["node_hi"])
    with pytest.raises(ValueError, match="no kernel"):
        TK.lbvh_tail(m["range_first"], m["range_last"][:39],
                     m["range_first"], key.to("meta"), m["node_lo"][:40],
                     m["node_hi"][:40])
    with pytest.raises(ValueError, match="no kernel"):
        TK.lbvh_refit(m["left_child"], m["right_child"], m["rope"],
                      m["range_first"], m["range_last"], m["leaf_perm"],
                      m["node_lo"][:40], m["node_hi"][:40])
    with pytest.raises(ValueError, match="bits"):
        KM.morton_key(torch.zeros((4, 3)), torch.zeros((4, 3)), bits=16)


# ---------------------------------------------------------------------------
# on the card (python -m pytest -m cuda tests/test_torch_build_path.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _launches():
    return (KM.morton64.launches, TK.karras_ranges.launches,
            TK.lbvh_tail.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("n,dim", SHAPES + [(5000, 3), (4099, 2)])
def test_card_build_and_refit_match_twins(cuda_device, n, dim, bits, kind):
    lo, hi = boxes(n, dim, kind, seed=7 * n + dim)
    want = TL.build(_torch_boxes(lo, hi), bits=bits)
    before = _launches()
    got = TL.build(_torch_boxes(lo, hi, cuda_device), bits=bits)
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 1 for b in before)
    same_tree(got, want)
    if dim == 3:
        assert "records" in got.__dict__
        same_records(got.records, want.records)
    mlo, mhi = boxes(n, dim, kind, seed=n + 11)
    want_r = TL.refit(want, _torch_boxes(mlo, mhi))
    before = _launches()
    got_r = TL.refit(got, _torch_boxes(mlo, mhi, cuda_device))
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1], before[2] + 1)
    same_tree(got_r, want_r)
    if dim == 3:
        same_records(got_r.records, want_r.records)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("dim", [1, 2, 3, 6, 10])
def test_card_build_runs_no_host_loop(cuda_device, monkeypatch, dim, bits):
    """With the twin's interleave and sparse table made to raise, the
    card's build and refit still run: neither is on the card's path."""
    def boom(*a, **k):
        raise AssertionError("a host-loop twin ran on the card's build")

    monkeypatch.setattr(TM, "_interleave", boom)
    monkeypatch.setattr(TK, "aabb_rmq", boom)
    monkeypatch.setattr(TK, "lbvh_tail_ref", boom)
    monkeypatch.setattr(KM, "morton_key_ref", boom)
    lo, hi = boxes(3000, dim, "uniform", seed=dim)
    tree = TL.build(_torch_boxes(lo, hi, cuda_device), bits=bits)
    TL.refit(tree, _torch_boxes(hi, hi, cuda_device))
    torch.cuda.synchronize()
    assert tree.leaf_perm.shape == (3000,)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 6, 7, 10, 21])
def test_card_key_kernel_matches_twin(cuda_device, dim, bits, offset):
    """Every instance of the key kernel, on rows that start 16-byte aligned
    and (offset 1) not, with a ragged last group of four points."""
    n = 4099
    rng = np.random.default_rng(dim + bits)
    raw = rng.uniform(-1, 2, (n + offset, dim)).astype(np.float32)
    raw[5, 0] = np.nan
    lo = torch.from_numpy(raw)[offset:]
    hi = lo + 0.01
    want = KM.morton_key_ref(lo, hi, bits)
    before = KM.morton64.launches
    got = KM.morton_key(lo.to(cuda_device), hi.to(cuda_device), bits)
    torch.cuda.synchronize()
    assert KM.morton64.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_card_tree_moved_from_the_cpu_packs_records_at_first_use(cuda_device):
    lo, hi = boxes(500, 3, "uniform")
    tree = TL.build(_torch_boxes(lo, hi))
    moved = tree.to(cuda_device)
    assert "records" not in moved.__dict__
    same_records(moved.records, tree.records)
