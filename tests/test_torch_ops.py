"""PyTorch port vs the JAX package: the stand-alone kernel ops
(``repro_torch.kernels.ops`` against ``repro.kernels.ops``, whose Pallas
kernels run in interpret mode here) and the oracles of ``kernels.ref``.

``morton64`` is compared bit for bit. ``bruteforce_knn`` is bit-identical
wherever the reference's own float order is the one the port follows:
XLA:CPU computes the reference kernel's q.p panel with fused
multiply-adds when the panel of points is 512 wide (every N > 512 at the
default ``bn``) or 64 wide, but for other widths it takes other orders
(unfused, or one that varies from column to column; mapped on the CPU
for widths 8 to 512). There distances are held to the expansion's
rounding: |d^2 - d_ref^2| <= 2 (dim + 3) u (|q|^2 + |p|^2), u = 2^-24, the
sum of the first-order error bounds of two evaluations; at dim 64 to
relative 2e-6 on distances. Indices are equal except where the
reference's neighbouring distances lie within that tolerance. The
reference's tail when k > N is reproduced index for index. The JAX side
keeps k <= 16: its selection unrolls k rounds at trace time.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_parity import np_of, one_torch_thread  # noqa: F401 (fixture)
from repro.kernels import ops as JO
from repro.kernels import ref as JR
import repro_torch.kernels as TKS
from repro_torch.kernels import morton as TM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ray_box as TRB
from repro_torch.kernels import ref as TRF

# the package exports the function under the module's name
TB = importlib.import_module("repro_torch.kernels.bruteforce_knn")

U = 2.0 ** -24


def t_of(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# morton64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("n,dim", [(8, 1), (100, 2), (1000, 3), (513, 4),
                                   (64, 6), (32, 10)])
def test_morton64_bit_identical(n, dim, explicit):
    rng = np.random.default_rng(13 + n + dim)
    pts = rng.uniform(-2, 3, (n, dim)).astype(np.float32)
    bounds = ((pts.min(0) - 0.5).astype(np.float32),
              (pts.max(0) + 0.25).astype(np.float32)) if explicit else ()
    jh, jl = map(np.asarray, JO.morton64(pts, *bounds))
    th, tl = TO.morton64(t_of(pts), *map(t_of, bounds))
    assert th.dtype == torch.int64 and tl.dtype == torch.int64
    np.testing.assert_array_equal(jh.astype(np.int64), np_of(th))
    np.testing.assert_array_equal(jl.astype(np.int64), np_of(tl))
    if dim in (2, 3, 4):
        assert (jh != 0).any()                      # the hi lane is used


def test_morton64_clamps_outside_the_scene_and_casts_float16():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 2, (200, 3)).astype(np.float16)
    lo, hi = np.zeros(3, np.float16), np.ones(3, np.float16)
    jh, jl = map(np.asarray, JO.morton64(pts, lo, hi))
    th, tl = TO.morton64(*map(t_of, (pts, lo, hi)))
    np.testing.assert_array_equal(jh.astype(np.int64), np_of(th))
    np.testing.assert_array_equal(jl.astype(np.int64), np_of(tl))


# ---------------------------------------------------------------------------
# bruteforce_knn
# ---------------------------------------------------------------------------

def knn_case(q, n, dim, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (q, dim)).astype(dtype),
            rng.uniform(0, 1, (n, dim)).astype(dtype))


def both(qs, ps, k, **kw):
    jd, ji = map(np.asarray, JO.bruteforce_knn(qs, ps, k, **kw))
    d, i = TO.bruteforce_knn(t_of(qs), t_of(ps), k, **kw)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.shape == i.shape == (qs.shape[0], k)
    return jd, ji, np_of(d), np_of(i)


def d2_tol(qs, ps, idx):
    """2 (dim + 3) u (|q|^2 + |p|^2) per (query, neighbour)."""
    q2 = (qs.astype(np.float64) ** 2).sum(1)[:, None]
    p2 = (ps.astype(np.float64) ** 2).sum(1)[np.maximum(idx, 0)]
    return 2 * (qs.shape[1] + 3) * U * (q2 + p2)


def assert_close_knn(jd, ji, d, i, tol_d2):
    """Distances within tol on d^2 (inf where the reference has inf);
    indices equal except among reference distances within 2 tol."""
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(fin, np.isfinite(d))
    jd2 = np.where(fin, jd, 0).astype(np.float64) ** 2
    d2 = np.where(fin, d, 0).astype(np.float64) ** 2
    assert (np.abs(d2 - jd2) <= tol_d2).all()
    near = np.zeros_like(fin)
    gap = (np.abs(np.diff(jd2, axis=1)) <= 2 * np.maximum(tol_d2[:, 1:],
                                                           tol_d2[:, :-1])) \
        & fin[:, 1:]
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert ((i == ji) | near).all()


# (q, n, dim, k, exact): exact where the reference's panel of points is
# 512 or 64 wide; the (100, 300) and (8, 8) panels are 304 and 8 wide
SWEEP = [(16, 64, 2, 1, True), (100, 300, 3, 8, False),
         (256, 512, 3, 16, True), (33, 1000, 5, 4, True),
         (8, 8, 3, 8, False), (64, 1000, 3, 8, True)]


@pytest.mark.parametrize("q,n,dim,k,exact", SWEEP)
def test_bruteforce_knn_sweep(q, n, dim, k, exact):
    qs, ps = knn_case(q, n, dim, seed=q + n + dim)
    jd, ji, d, i = both(qs, ps, k)
    if exact:
        np.testing.assert_array_equal(jd, d)
        np.testing.assert_array_equal(ji, i)
    else:
        assert_close_knn(jd, ji, d, i, d2_tol(qs, ps, ji))
        np.testing.assert_array_equal(ji, i)     # these draws have no near ties


def test_bruteforce_knn_tail_one_panel():
    """k > N <= bn: the rows past N are (inf, -1)."""
    qs, ps = knn_case(20, 5, 3, seed=1)
    jd, ji, d, i = both(qs, ps, 8)
    np.testing.assert_array_equal(ji, i)
    assert (ji[:, 5:] == -1).all() and np.isinf(jd[:, 5:]).all()
    assert_close_knn(jd, ji, d, i, d2_tol(qs, ps, ji))


def test_bruteforce_knn_tail_more_panels():
    """k > N > bn: the rows past N repeat, at distance inf, the nearest
    point below the last panel's start."""
    qs, ps = knn_case(20, 12, 3, seed=2)
    jd, ji, d, i = both(qs, ps, 16, bn=8)
    np.testing.assert_array_equal(ji, i)
    assert np.isinf(jd[:, 12:]).all() and (ji[:, 12:] >= 0).all()
    assert_close_knn(jd, ji, d, i, d2_tol(qs, ps, ji))
    # the tail is the nearest among points 0..7, not the nearest overall
    exact = ((qs[:, None, :].astype(np.float64) - ps[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i[:, 12], exact[:, :8].argmin(1))
    assert (i[:, 12] != i[:, 0]).any()


def test_bruteforce_knn_float16_inputs():
    qs, ps = knn_case(64, 256, 3, seed=3, dtype=np.float16)
    jd, ji, d, i = both(qs, ps, 4)
    np.testing.assert_array_equal(jd, d)
    np.testing.assert_array_equal(ji, i)


def test_bruteforce_knn_ties_go_to_the_lower_index():
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 1, (150, 3)).astype(np.float32)
    ps = base[rng.integers(0, 150, 600)]               # duplicate points
    qs = np.concatenate([ps[:20], rng.uniform(0, 1, (20, 3))]).astype(np.float32)
    jd, ji, d, i = both(qs, ps, 8)
    np.testing.assert_array_equal(jd, d)
    np.testing.assert_array_equal(ji, i)
    tied = jd[:, 1:] == jd[:, :-1]
    assert tied.sum() > 20 and (ji[:, 1:][tied] > ji[:, :-1][tied]).all()


def test_bruteforce_knn_wide_rows():
    """dim 64: XLA's dot over the 128-wide padded row sums in another
    order; distances to relative 2e-6."""
    qs, ps = knn_case(10, 64, 64, seed=5)
    jd, ji, d, i = both(qs, ps, 5)
    np.testing.assert_allclose(d, jd, rtol=2e-6, atol=0)
    # a relative 2e-6 on d is 4e-6 on d^2
    assert_close_knn(jd, ji, d, i, 4e-6 * jd.astype(np.float64) ** 2)


def test_block_keywords_change_nothing_but_the_tail():
    qs, ps = knn_case(40, 300, 3, seed=6)
    want = TO.bruteforce_knn(t_of(qs), t_of(ps), 8)
    for kw in ({"bq": 8}, {"bq": 1024}, {"bn": 64}, {"bn": 8}):
        got = TO.bruteforce_knn(t_of(qs), t_of(ps), 8, **kw)
        assert all(torch.equal(a, b) for a, b in zip(want, got)), kw


def test_twin_chunks_do_not_change_the_answer(monkeypatch):
    qs, ps = (t_of(a) for a in knn_case(30, 700, 3, seed=7))
    want = TB.bruteforce_knn_ref(qs, ps, 16, bn=256)
    monkeypatch.setattr(TB, "_CHUNK_ELEMENTS", 30 * 3 * 37)
    got = TB.bruteforce_knn_ref(qs, ps, 16, bn=256)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_large_k_against_the_oracle():
    """k = 256 (the kernel's cap) against ``ref.bruteforce_knn_ref``, and
    the multi-panel tail at k > N with the default panel width."""
    qs, ps = knn_case(16, 2000, 3, seed=8)
    d, i = TO.bruteforce_knn(t_of(qs), t_of(ps), 256)
    wd, wi = TRF.bruteforce_knn_ref(t_of(qs), t_of(ps), 256)
    assert_close_knn(np_of(wd), np_of(wi), np_of(d), np_of(i),
                     d2_tol(qs, ps, np_of(wi)))
    qs, ps = knn_case(16, 200, 3, seed=9)
    d, i = TO.bruteforce_knn(t_of(qs), t_of(ps), 256, bn=128)
    exact = ((qs[:, None, :].astype(np.float64) - ps[None]) ** 2).sum(-1)
    assert torch.isinf(d[:, 200:]).all()
    np.testing.assert_array_equal(np_of(i[:, 200:]),
                                  np.repeat(exact[:, :128].argmin(1)[:, None],
                                            56, 1))
    wd, wi = TRF.bruteforce_knn_ref(t_of(qs), t_of(ps), 256)
    assert (np_of(wi[:, 200:]) == -1).all()
    assert_close_knn(np_of(wd)[:, :200], np_of(wi)[:, :200],
                     np_of(d)[:, :200], np_of(i)[:, :200],
                     d2_tol(qs, ps, np_of(wi)[:, :200]))


def test_ops_validate_their_inputs():
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="k must be"):
        TO.bruteforce_knn(z, z, 257)
    with pytest.raises(ValueError, match=r"\(N, dim\)"):
        TO.bruteforce_knn(z, torch.zeros((4, 2)), 2)
    with pytest.raises(ValueError, match="scene bounds"):
        TO.morton64(z, torch.zeros(2), torch.ones(2))
    d, i = TO.bruteforce_knn(z, torch.zeros((0, 3)), 2)
    assert torch.isinf(d).all() and (i == -1).all()
    h, lo = TO.morton64(torch.zeros((0, 3)), torch.zeros(3), torch.ones(3))
    assert h.shape == lo.shape == (0,)


def test_package_exports():
    assert TKS.bruteforce_knn is TO.bruteforce_knn
    assert TKS.morton64 is TO.morton64
    assert TKS.ray_box_nearest is TRB.ray_box_nearest
    assert TKS.ops is TO and TKS.ref is TRF
    assert TM.morton64.launches >= 0 and TB.bruteforce_knn.launches >= 0
    assert set(TKS.__all__) == {"ops", "ref", "morton64", "bruteforce_knn",
                                "ray_box_nearest", "bvh_traverse_spatial",
                                "bvh_traverse_knn"}


def test_ops_ray_box_nearest_matches_the_reference():
    rng = np.random.default_rng(10)
    lo = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    hi = (lo + 0.05).astype(np.float32)
    o = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    dv = rng.normal(size=(50, 3)).astype(np.float32)
    jt, ji = map(np.asarray, JO.ray_box_nearest(o, dv, lo, hi))
    t, i = TO.ray_box_nearest(*map(t_of, (o, dv, lo, hi)), br=8, bb=64)
    np.testing.assert_array_equal(jt, np_of(t))
    np.testing.assert_array_equal(ji, np_of(i))


# ---------------------------------------------------------------------------
# the oracles (kernels.ref) against the reference's ref.py
# ---------------------------------------------------------------------------

def test_morton64_ref_matches_reference():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-2, 3, (300, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    jh, jl = map(np.asarray, JR.morton64_ref(pts, lo, hi))
    th, tl = TRF.morton64_ref(*map(t_of, (pts, lo, hi)))
    np.testing.assert_array_equal(jh.astype(np.int64), np_of(th))
    np.testing.assert_array_equal(jl.astype(np.int64), np_of(tl))


@pytest.mark.parametrize("q,n,dim,k", [(30, 70, 3, 8), (50, 600, 5, 16),
                                       (20, 100, 2, 1)])
def test_bruteforce_knn_ref_matches_reference(q, n, dim, k):
    """Both oracles use a library matrix product: held to the expansion's
    rounding, indices equal."""
    qs, ps = knn_case(q, n, dim, seed=12 + q)
    jd, ji = map(np.asarray, JR.bruteforce_knn_ref(qs, ps, k))
    d, i = TRF.bruteforce_knn_ref(t_of(qs), t_of(ps), k)
    assert_close_knn(jd, ji, np_of(d), np_of(i), d2_tol(qs, ps, ji))
    np.testing.assert_array_equal(ji, np_of(i))


def test_ray_box_nearest_ref_matches_reference():
    rng = np.random.default_rng(13)
    lo = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    hi = (lo + 0.05).astype(np.float32)
    lo[1::3], hi[1::3] = lo[::3][:lo[1::3].shape[0]], hi[::3][:hi[1::3].shape[0]]
    o = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    dv = rng.normal(size=(40, 3)).astype(np.float32)
    dv[::4, 0] = 0.0
    jt, ji = map(np.asarray, JR.ray_box_nearest_ref(o, dv, lo, hi))
    t, i = TRF.ray_box_nearest_ref(*map(t_of, (o, dv, lo, hi)))
    np.testing.assert_array_equal(jt, np_of(t))
    np.testing.assert_array_equal(ji, np_of(i))
    wt, wi = TRB.ray_box_nearest_ref(*map(t_of, (o, dv, lo, hi)))
    assert torch.equal(wt, t) and torch.equal(wi, i)
