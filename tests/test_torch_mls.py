"""Moving least squares interpolation: the port's ``mls_interpolate``
against the JAX reference on the CPU, and on the card against the CPU
(tests marked ``cuda``).

The neighbours are the reference's exactly. The values come from float32
solves in two frameworks, so each is held to a float64 solve of the same
systems (the same neighbours, the same float32 inputs, every step in
float64) within a bound derived for the float32 pipeline (``BOUND``
below), the port's and the reference's alike, and the reference's
exactness test (``tests/test_distributed.py``) is mirrored.

BOUND. With u = 2^-24 and, per target, the k neighbours' shifted basis
rows p_i (1, d, then d_a d_b), weights w_i and values f_i, the float64
fit c solves A c = b, A = sum_i w_i p_i p_i^T + reg I, b = sum_i w_i
p_i f_i; g = e_0^T A^-1 and rho_i = f_i - p_i . c, the fit's residual at
neighbour i. The float32 pipeline perturbs it as follows, each to first
order in u:

  * a weight: a distance d_i is within dd_i = (dim + 3)u d_i on the
    kernel route (a fused sum of dim squares, then sqrt), and within
    dd_i = min(E_i / d_i, sqrt(E_i)), E_i = 2 (dim + 3)u (|q|^2 + |p|^2),
    on the brute-force route, which both packages take at small N * T
    (its expansion |q|^2 - 2 q.p + |p|^2 is within E_i of d_i^2, the
    port's stated bound for it); so
    r_i = d_i / (1.1 d_k) is within dr_i = (dd_i + r_i dd_k) / (1.1 d_k)
    + 3u, and as |w'(r)| = 20 r (1 - r)^3 <= 2.11 on [0, 1] and evaluating
    ((1 - r)^2)^2 (4r + 1) adds at most 8u, |dw_i| <= eta_i = 2.11 dr_i +
    8u. A weight moves c_0 by g dw_i p_i rho_i: at most
    sum_i eta_i |g . p_i| rho_i;
  * a basis entry: d = x_i - x_t rounds once, a product d_a d_b twice
    more, |dp_i| <= 3u |p_i|, which moves c_0 by at most sum_i w_i 3u
    (|g| |p_i| rho_i + |g . p_i| |p_i| . |c|);
  * the products p w and (p w)_a p_b round once each and the k-term sums
    add gamma_k ~ k u: at most (k + 2)u |g| sum_i w_i |p_i| (|p_i| . |c|
    + |f_i|);
  * reg rounds to float32 (u reg |g| |c|), and LU with partial pivoting
    solves (A + E) c' = b' with |E| <= gamma_3m P |L| |U| (Higham,
    Accuracy and Stability of Numerical Algorithms, Thm. 9.4, the
    triangular solves included): at most 3m u |g| P |L| |U| |c|.

BOUND is twice the sum (for the second-order terms), all of it evaluated
in float64. Keeping g . p_i and the residuals, where a componentwise
bound would take |g| |p_i| and |f_i| + |p_i| . |c|, is what keeps it
near the errors seen rather than orders of magnitude above them.
"""
import numpy as np
import pytest
import scipy.linalg
import torch

from repro_torch import BVH, ExecutionPolicy, mls_interpolate
from repro_torch.core import geometry as TG
from repro_torch.core import interpolation as TI
from repro_torch.core import predicates as TP
from repro_torch.kernels import bvh_traverse as KT

CPU = "cpu"
U = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def smooth(x):
    """bench_mls.py's function."""
    return np.sin(2 * x[:, 0]) * np.cos(3 * x[:, 1]) + x[:, 2]


def _basis64(d, degree):
    parts = [np.ones(d.shape[:-1] + (1,))]
    if degree >= 1:
        parts.append(d)
    if degree >= 2:
        iu, ju = np.triu_indices(d.shape[-1])
        parts.append(d[..., iu] * d[..., ju])
    return np.concatenate(parts, -1)


def float64_solve(src, values, tgt, idx, degree, reg=1e-8, expansion=False):
    """(c0, BOUND) per target: the float64 solution of the systems that
    the neighbours `idx` (T, k) give, and the module docstring's bound on
    a float32 pipeline's distance from it; `expansion`: the kNN distances
    came from brute force, else from the kernel route."""
    src, values, tgt = (np.asarray(a, np.float64) for a in (src, values, tgt))
    t, k = idx.shape
    dim = src.shape[1]
    dx = src[idx] - tgt[:, None, :]
    d = np.sqrt((dx * dx).sum(-1))
    radius = np.maximum(d[:, -1:], 1e-30) * 1.1
    r = np.clip(d / radius, 0.0, 1.0)
    w = (1.0 - r) ** 4 * (4.0 * r + 1.0)
    p = _basis64(dx, degree)                                 # (T, k, m)
    m = p.shape[-1]
    f = values[idx]
    a = np.einsum("tki,tk,tkj->tij", p, w, p) + reg * np.eye(m)
    b = np.einsum("tki,tk,tk->ti", p, w, f)
    c = np.linalg.solve(a, b[..., None])[..., 0]
    g = np.linalg.inv(a)[:, 0, :]                            # e_0^T A^-1
    gp = np.abs(np.einsum("ti,tki->tk", g, p))               # |g . p_i|
    ag, ap, ac = np.abs(g), np.abs(p), np.abs(c)
    rho = np.abs(f - np.einsum("tki,ti->tk", p, c))          # residuals
    pc = np.einsum("tki,ti->tk", ap, ac)                     # |p_i| . |c|
    dd = (dim + 3) * U * d
    if expansion:
        e = 2 * (dim + 3) * U * ((src * src).sum(-1)[idx]
                                 + (tgt * tgt).sum(-1)[:, None])
        dd = np.minimum(e / np.maximum(d, 1e-300), np.sqrt(e))
    eta = 2.11 * ((dd + r * dd[:, -1:]) / radius + 3 * U) + 8 * U
    lu = np.empty_like(a)
    for i in range(t):
        perm, low, up = scipy.linalg.lu(a[i])
        lu[i] = perm @ (np.abs(low) @ np.abs(up))
    weights = (eta * gp * rho).sum(-1)
    basis = 3 * U * (w * (np.einsum("ti,tki->tk", ag, ap) * rho
                          + gp * pc)).sum(-1)
    sums = (k + 2) * U * np.einsum("ti,tki,tk->t", ag, ap, w * (pc + np.abs(f)))
    solve = U * np.einsum("ti,ti->t", ag, reg * ac
                          + 3 * m * np.einsum("tij,tj->ti", lu, ac))
    return c[:, 0], 2.0 * (weights + basis + sums + solve)


def reference_neighbours(src, tgt, k):
    import jax.numpy as jnp
    from repro.core import BVH as JBVH
    from repro.core import geometry as JG
    from repro.core import predicates as JP
    res = JBVH(JG.Points(jnp.asarray(src))).query(
        JP.nearest(JG.Points(jnp.asarray(tgt)), k=k))
    return np.asarray(res.indices)


def port_neighbours(src, tgt, k, dev=CPU):
    res = BVH(TG.Points(torch.from_numpy(src).to(dev)),
              policy=ExecutionPolicy(device=dev)).query(
        TP.nearest(TG.Points(torch.from_numpy(tgt).to(dev)), k=k))
    return res.indices.cpu().numpy()


def clouds(n=1000, t=160, dim=3, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    tgt = rng.uniform(0, 1, (t, dim)).astype(np.float32)
    values = smooth(src) if dim == 3 else np.sin(3 * src.sum(1))
    return src, values.astype(np.float32), tgt


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_mls_matches_reference_within_the_float64_bound(degree, dim):
    from repro.core import mls_interpolate as jmls
    src, vals, tgt = clouds(dim=dim, seed=degree + 10 * dim)
    m = TI.polynomial_basis_size(dim, degree)
    k = min(2 * m + 2, len(src))
    idx = port_neighbours(src, tgt, k)
    np.testing.assert_array_equal(idx, reference_neighbours(src, tgt, k))
    # N * T <= 2^22: both packages' kNN takes the brute-force route
    assert len(src) * len(tgt) <= 1 << 22
    c64, bound = float64_solve(src, vals, tgt, idx, degree, expansion=True)
    got = mls_interpolate(src, vals, tgt, degree=degree, device=CPU).numpy()
    want = np.asarray(jmls(src, vals, tgt, degree=degree))
    assert got.shape == want.shape == (len(tgt),) and got.dtype == np.float32
    assert (np.abs(got - c64) <= bound).all()
    assert (np.abs(want - c64) <= bound).all()


def test_mls_interpolation_exactness():
    """tests/test_distributed.py's exactness test on the port."""
    rng = np.random.default_rng(8)
    src = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    tgt = rng.uniform(0.2, 0.8, (50, 3)).astype(np.float32)
    # degree-1 MLS reproduces affine functions exactly
    f = lambda x: 1.5 * x[:, 0] - 2.0 * x[:, 1] + 0.25 * x[:, 2] + 3.0
    out = mls_interpolate(src, f(src), tgt, degree=1, device=CPU)
    assert np.allclose(out.numpy(), f(tgt), atol=1e-3)
    # degree-2 reproduces quadratics
    g = lambda x: x[:, 0] ** 2 - x[:, 1] * x[:, 2]
    out2 = mls_interpolate(src, g(src), tgt, degree=2, device=CPU)
    assert np.allclose(out2.numpy(), g(tgt), atol=5e-3)
    # smooth function: error decreases with k
    h = lambda x: np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
    e_small = np.abs(mls_interpolate(src, h(src), tgt, k=6, device=CPU).numpy()
                     - h(tgt)).mean()
    e_big = np.abs(mls_interpolate(src, h(src), tgt, k=24, device=CPU).numpy()
                   - h(tgt)).mean()
    assert e_big <= e_small * 1.5


def test_basis_and_weights_match_reference():
    import jax
    import jax.numpy as jnp
    from repro.core import interpolation as JI
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    for degree in (0, 1, 2):
        want = np.asarray(jax.vmap(lambda v: JI._basis(v, degree))(jnp.asarray(x)))
        got = TI._basis(torch.from_numpy(x), degree).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape[1] == TI.polynomial_basis_size(4, degree) \
            == JI.polynomial_basis_size(4, degree)
    r = np.concatenate([rng.uniform(-0.5, 1.5, 200), [0.0, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(TI.wendland_c2(torch.from_numpy(r)).numpy(),
                                  np.asarray(JI.wendland_c2(jnp.asarray(r))))
    with pytest.raises(ValueError, match="degree"):
        TI.polynomial_basis_size(3, 3)


def test_mls_defaults_and_placement(monkeypatch):
    """k defaults to min(2m + 2, N); tensors run where they live, arrays
    go to the card and raise without one."""
    src, vals, tgt = clouds(n=6, t=5)
    calls = []
    real = BVH._knn_impl

    def spy(self, preds, pol):
        calls.append(preds.k)
        return real(self, preds, pol)

    monkeypatch.setattr(BVH, "_knn_impl", spy)
    out = mls_interpolate(torch.from_numpy(src), torch.from_numpy(vals),
                          torch.from_numpy(tgt), degree=2)
    assert calls == [6] and out.device.type == "cpu"
    assert torch.isfinite(out).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mls_interpolate(src, vals, tgt)


# ---------------------------------------------------------------------------
# on the card (python -m pytest -m cuda tests/test_torch_mls.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_mls_on_the_card_takes_the_knn_kernel(cuda_device, degree):
    """On the card: one kNN kernel launch, the CPU's neighbours, values
    within BOUND of the float64 solve."""
    src, vals, tgt = clouds(n=20000, t=4096, seed=degree)
    k = 2 * TI.polynomial_basis_size(3, degree) + 2
    idx = port_neighbours(src, tgt, k, cuda_device)
    np.testing.assert_array_equal(idx, port_neighbours(src, tgt, k))
    before = KT.bvh_traverse_knn.launches
    got = mls_interpolate(src, vals, tgt, degree=degree, device=cuda_device)
    assert KT.bvh_traverse_knn.launches == before + 1
    c64, bound = float64_solve(src, vals, tgt, idx, degree)
    assert (np.abs(got.cpu().numpy() - c64) <= bound).all()
