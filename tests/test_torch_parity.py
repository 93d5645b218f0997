"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py),
and tests of the comparators themselves.

Inputs are seeded numpy arrays handed to both packages; the JAX package
runs on the CPU (its Pallas kernels in interpret mode), the port on the
CPU with its kernels' plain twins. Comparators cover the three strengths
the reference pins: bit-identical (LBVH fields, counts, buffers),
set-equal (CSR fill, whose order depends on the route) and equal up to
fp ties (kNN).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as JG
from repro_torch import convert

CPU = "cpu"

#: the port's route names -> the reference's
ROUTE_MAP = {"kernel": "pallas", "bruteforce": "bruteforce", "loop": "loop"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's CPU tensors on one thread: the suite runs several
    pytest workers at once, and PyTorch would start one thread per core
    in each of them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cloud(n: int, dim: int, kind: str = "uniform", seed: int = 0) -> np.ndarray:
    """(n, dim) float32 points: uniform in the unit cube, clustered around
    a few centres, or with many duplicate rows (duplicate Morton codes)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.uniform(0, 1, (n, dim))
    elif kind == "clustered":
        centres = rng.uniform(0, 1, (4, dim))
        x = centres[rng.integers(0, 4, n)] + rng.normal(0, 0.01, (n, dim))
    elif kind == "duplicates":
        base = rng.uniform(0, 1, (max(n // 4, 1), dim))
        x = base[rng.integers(0, base.shape[0], n)]
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def geoms(kind: str, arrays):
    """The same geometry for both packages: (jax_geom, torch_geom)."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    jcls = {"points": JG.Points, "boxes": JG.Boxes, "spheres": JG.Spheres}[kind]
    return (jcls(*(jnp.asarray(a) for a in arrays)),
            convert.geometry_from_numpy(kind, arrays, CPU))


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_csr_equal_sets(off_a, idx_a, off_b, idx_b):
    """Offsets equal, and the same index set per query."""
    off_a, off_b = np_of(off_a), np_of(off_b)
    idx_a, idx_b = np_of(idx_a), np_of(idx_b)
    np.testing.assert_array_equal(off_a, off_b)
    for q in range(off_a.shape[0] - 1):
        a = np.sort(idx_a[off_a[q]:off_a[q + 1]])
        b = np.sort(idx_b[off_b[q]:off_b[q + 1]])
        np.testing.assert_array_equal(a, b, err_msg=f"query {q}")


def assert_knn_equal(d_a, i_a, d_b, i_b, *, rtol: float = 0.0,
                     atol: float = 0.0):
    """Distances equal (within the stated tolerance) and indices equal
    except where the distance ties its neighbour in the row."""
    d_a, d_b = np_of(d_a), np_of(d_b)
    i_a, i_b = np_of(i_a), np_of(i_b)
    np.testing.assert_allclose(d_a, d_b, rtol=rtol, atol=atol)
    tie = np.zeros(d_b.shape, bool)
    close = np.isclose(d_b[:, 1:], d_b[:, :-1], rtol=rtol, atol=atol)
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    bad = (i_a != i_b) & ~tie
    assert not bad.any(), f"{int(bad.sum())} kNN indices differ beyond ties"


# ---------------------------------------------------------------------------
# the comparators catch what they must and pass what they may
# ---------------------------------------------------------------------------

def test_knn_comparator_allows_tie_swaps_only():
    d = np.array([[0.1, 0.2, 0.2, 0.3]], np.float32)
    i = np.array([[4, 7, 9, 1]], np.int32)
    assert_knn_equal(d, i, d, i[:, [0, 2, 1, 3]])           # tie swapped
    with pytest.raises(AssertionError, match="beyond ties"):
        assert_knn_equal(d, i, d, i[:, [1, 0, 2, 3]])
    with pytest.raises(AssertionError):
        assert_knn_equal(d + np.float32(1e-7), i, d, i)


def test_csr_comparator_checks_offsets_and_sets():
    off = np.array([0, 2, 3], np.int32)
    assert_csr_equal_sets(off, np.array([5, 1, 2]), off, np.array([1, 5, 2]))
    with pytest.raises(AssertionError):
        assert_csr_equal_sets(off, np.array([5, 1, 2]), off,
                              np.array([5, 2, 1]))
    with pytest.raises(AssertionError):
        assert_csr_equal_sets(off, np.array([5, 1, 2]),
                              np.array([0, 1, 3], np.int32),
                              np.array([5, 1, 2]))
