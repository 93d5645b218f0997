"""PyTorch port vs the JAX package: the traversal kernels' twins against
``repro.kernels.bvh_traverse`` (Pallas, interpret mode) on one tree,
built by the JAX package and carried across with ``convert``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import cloud, np_of, one_torch_thread  # noqa: F401 (fixture)
from repro.core import geometry as JG
from repro.core import lbvh as JL
from repro.kernels import bvh_traverse as JT
from repro_torch import convert
from repro_torch.core import lbvh as TL
from repro_torch.kernels import bvh_traverse as TT


@functools.lru_cache(maxsize=None)
def _trees(n, dim, kind="points", seed=0):
    """(jax_tree, port_tree) over the same values: Points (lo == hi) or
    Boxes; the port's tree is the JAX tree carried across."""
    lo = cloud(n, dim, "uniform", seed=seed)
    hi = lo if kind == "points" else lo + np.random.default_rng(seed).uniform(
        0.0, 0.1, lo.shape).astype(np.float32)
    jt = JL.build(JG.Boxes(jnp.asarray(lo), jnp.asarray(hi)))
    tt = convert.lbvh_from_numpy({f: np.asarray(getattr(jt, f))
                                  for f in TL.FIELDS}, "cpu")
    return jt, tt


def _spatial(jt, tt, q_lo, q_hi, r, **kw):
    j = JT.bvh_traverse_spatial(
        jt.node_lo, jt.node_hi, jt.rope, jt.left_child, jt.range_last,
        jt.leaf_perm, jnp.asarray(q_lo), jnp.asarray(q_hi), jnp.asarray(r),
        interpret=True, **{k: (jnp.asarray(v) if k == "min_pos" else v)
                           for k, v in kw.items()})
    t = TT.bvh_traverse_spatial(
        tt.node_lo, tt.node_hi, tt.rope, tt.left_child, tt.range_last,
        tt.leaf_perm, torch.from_numpy(q_lo), torch.from_numpy(q_hi),
        torch.from_numpy(r), **{k: (torch.from_numpy(v) if k == "min_pos" else v)
                               for k, v in kw.items()})
    return j, t


def _knn(jt, tt, qp, k):
    j = JT.bvh_traverse_knn(jt.node_lo, jt.node_hi, jt.rope, jt.left_child,
                            jt.leaf_perm, jnp.asarray(qp), k=k, interpret=True)
    t = TT.bvh_traverse_knn(tt.node_lo, tt.node_hi, tt.rope, tt.left_child,
                            tt.leaf_perm, torch.from_numpy(qp), k=k)
    return j, t


def _assert_bit_identical(j, t):
    for a, b in zip(j, t):
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _queries(kind, q, dim, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (q, dim)).astype(np.float32)
    zero = np.zeros((q,), np.float32)
    if kind == "point":
        return c, c, zero
    if kind == "box":
        return c, (c + np.float32(0.15)).astype(np.float32), zero
    return c, c, np.full((q,), 0.12, np.float32)


@pytest.mark.parametrize("qkind", ["point", "box", "sphere"])
@pytest.mark.parametrize("values", ["points", "boxes"])
@pytest.mark.parametrize("dim", [2, 3, 5])
def test_spatial_twin_bit_identical_to_pallas(dim, values, qkind):
    jt, tt = _trees(400, dim, values, seed=dim)
    q_lo, q_hi, r = _queries(qkind, 64, dim, seed=10 + dim)
    if qkind == "point" and values == "points":
        q_lo = q_hi = cloud(400, dim, "uniform", seed=dim)[:64]   # exact hits
    j, t = _spatial(jt, tt, q_lo, q_hi, r, capacity=16,
                    fine_sqrt=values == "points")
    _assert_bit_identical(j, t)


@pytest.mark.parametrize("capacity", [1, 3])
@pytest.mark.parametrize("fine_sqrt", [False, True])
def test_spatial_capacity_clamp_and_min_pos(capacity, fine_sqrt):
    """Counts stay full while the buffer clamps; the pair-traversal filter
    skips subtrees whose last sorted position is <= min_pos."""
    jt, tt = _trees(300, 3, "points", seed=5)
    q_lo, q_hi, r = _queries("sphere", 50, 3, seed=6)
    mp = np.random.default_rng(7).integers(-1, 300, 50).astype(np.int32)
    j, t = _spatial(jt, tt, q_lo, q_hi, r, capacity=capacity,
                    fine_sqrt=fine_sqrt)
    _assert_bit_identical(j, t)
    assert int(np_of(t[0]).max()) > capacity         # the clamp was exercised
    full = np_of(t[0])
    j, t = _spatial(jt, tt, q_lo, q_hi, r, capacity=capacity,
                    fine_sqrt=fine_sqrt, min_pos=mp)
    _assert_bit_identical(j, t)
    assert (np_of(t[0]) <= full).all() and (np_of(t[0]) < full).any()


@pytest.mark.parametrize("k", [1, 7, 16])
@pytest.mark.parametrize("values", ["points", "boxes"])
@pytest.mark.parametrize("dim", [2, 3, 5])
def test_knn_twin_bit_identical_to_pallas(dim, values, k):
    """Indices AND distances bit-identical: both sum the squares as
    d0*d0 then fma(dc, dc, s), and both take a correctly rounded sqrt."""
    jt, tt = _trees(400, dim, values, seed=dim)
    qp = np.random.default_rng(20 + dim).uniform(0, 1, (64, dim)).astype(np.float32)
    j, t = _knn(jt, tt, qp, k)
    _assert_bit_identical(j, t)


def test_knn_k_above_n_pads():
    jt, tt = _trees(5, 3, "points", seed=1)
    qp = cloud(8, 3, "uniform", seed=2)
    j, t = _knn(jt, tt, qp, 9)
    _assert_bit_identical(j, t)
    assert (np_of(t[1])[:, 5:] == -1).all() and np.isinf(np_of(t[0])[:, 5:]).all()


@functools.lru_cache(maxsize=None)
def _grid(dim):
    """Grid points spaced h = 0.1 apart (not exact in binary), so many
    pair distances sit within an ulp of h, h*sqrt(2), h*sqrt(3)."""
    m = 9 if dim == 2 else 6
    ax = (np.arange(m, dtype=np.float32) * np.float32(0.1)).astype(np.float32)
    g = np.stack(np.meshgrid(*([ax] * dim), indexing="ij"), -1).reshape(-1, dim)
    g = g.astype(np.float32)
    jt = JL.build(JG.Boxes(jnp.asarray(g), jnp.asarray(g)))
    tt = convert.lbvh_from_numpy({f: np.asarray(getattr(jt, f))
                                  for f in TL.FIELDS}, "cpu")
    return g, jt, tt


@pytest.mark.parametrize("factor", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("dim", [2, 3])
def test_boundary_grid_bit_identical(dim, factor):
    """The boundary-heavy fixture: spheres of radius h*sqrt(factor) around
    every grid point, so neighbours lie on the sphere up to rounding. The
    twin's leaf decisions equal the Pallas kernel's at every pair, and so
    do the kNN lists of points offset from the grid."""
    g, jt, tt = _grid(dim)
    r = np.full((g.shape[0],), np.float32(0.1) * np.sqrt(np.float32(factor)),
                np.float32)
    for fine_sqrt in (False, True):
        j, t = _spatial(jt, tt, g, g, r, capacity=32, fine_sqrt=fine_sqrt)
        _assert_bit_identical(j, t)
    j, t = _knn(jt, tt, (g + np.float32(0.03 * factor)).astype(np.float32), 6)
    _assert_bit_identical(j, t)


def test_spatial_empty_batch():
    _, tt = _trees(20, 3, "points", seed=3)
    z = torch.zeros((0, 3))
    c, b = TT.bvh_traverse_spatial(tt.node_lo, tt.node_hi, tt.rope,
                                   tt.left_child, tt.range_last, tt.leaf_perm,
                                   z, z, torch.zeros((0,)), capacity=4)
    assert c.shape == (0,) and b.shape == (0, 4)
