"""PyTorch port vs the JAX package: DBSCAN (FDBSCAN and FDBSCAN-DenseBox)
on seeded clouds, labels and core flags equal exactly (labels are min
original indices, so both packages' labels are canonical); plus the
grid preprocessing and the pointer jumping on their own."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import CPU, np_of, one_torch_thread  # noqa: F401
from repro_torch import EngineConfig, ExecutionPolicy, QueryEngine

# the packages export the function under the module's name
JD = importlib.import_module("repro.core.dbscan")
TD = importlib.import_module("repro_torch.core.dbscan")

ALGORITHMS = ["fdbscan", "fdbscan-densebox"]


def _both(X, eps, min_pts, algorithm, engine=None):
    jl, jc = JD.dbscan(X, eps, min_pts, algorithm=algorithm)
    tl, tc = TD.dbscan(torch.from_numpy(X), eps, min_pts, algorithm=algorithm,
                       policy=ExecutionPolicy(device=CPU, engine=engine))
    np.testing.assert_array_equal(np_of(tc), np.asarray(jc))
    np.testing.assert_array_equal(np_of(tl), np.asarray(jl))
    assert tl.dtype == torch.int32 and tc.dtype == torch.bool
    return tl, tc


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_dbscan_matches_reference(algorithm, seed):
    """The fixture of tests/test_clustering.py: two blobs and noise."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([
        rng.normal(0, 0.05, (40, 2)),
        rng.normal(2, 0.05, (40, 2)),
        rng.uniform(-1, 3, (10, 2)),
    ]).astype(np.float32)
    labels, core = _both(X, 0.2, 5, algorithm)
    assert set(np_of(labels).tolist()) >= {0, 40}          # both blobs
    assert (np_of(labels)[~np_of(core)] == -1).any()       # some noise


@pytest.mark.parametrize("case", [(11, 24, 0.3, 3), (12, 48, 0.12, 5),
                                  (13, 48, 0.45, 5), (14, 24, 0.07, 3)])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_dbscan_random_clouds_match_reference(algorithm, case):
    """Uniform clouds as in tests/test_clustering.py's property test."""
    seed, n, eps, min_pts = case
    X = np.random.default_rng(seed).uniform(0, 1, (n, 2)).astype(np.float32)
    _both(X, eps, min_pts, algorithm)


def _blobs_3d(seed=5):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.1, 0.9, (4, 3))
    X = np.concatenate([c + rng.normal(0, 0.01, (120, 3)) for c in centres]
                       + [rng.uniform(0, 1, (60, 3))])
    return X.astype(np.float32)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_dbscan_3d_blobs_through_the_callback_kernel(algorithm, monkeypatch):
    """The smoke's cloud in small: 3-D Gaussian blobs and noise, with
    dense cells for DenseBox. Every callback batch takes the kernel route
    (its twin here): core points, each hook round, the border round."""
    X = _blobs_3d()
    engine = QueryEngine()
    rounds = []
    round_fn = TD._min_core_label_round
    monkeypatch.setattr(TD, "_min_core_label_round",
                        lambda *a: rounds.append(1) or round_fn(*a))
    _, core = _both(X, 0.012, 3, algorithm, engine=engine)
    assert np_of(core).sum() > len(X) // 2
    # at least one hook round, then the border round
    assert len(rounds) >= 2
    assert engine.callback_batches == {"kernel": len(rounds) + 1, "loop": 0}
    if algorithm == "fdbscan-densebox":
        _, dense = TD._dense_cells(torch.from_numpy(X), 0.012, 3)
        assert np_of(dense).any()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_dbscan_takes_float64_arrays_as_float32(algorithm):
    """A float64 numpy array (numpy's default) is clustered in float32, as
    the reference's jnp.asarray takes it, and stays on the kernel route."""
    X = _blobs_3d(7).astype(np.float64)
    engine = QueryEngine()
    jl, jc = JD.dbscan(X, 0.012, 3, algorithm=algorithm)
    tl, tc = TD.dbscan(X, 0.012, 3, algorithm=algorithm,
                       policy=ExecutionPolicy(device=CPU, engine=engine))
    np.testing.assert_array_equal(np_of(tc), np.asarray(jc))
    np.testing.assert_array_equal(np_of(tl), np.asarray(jl))
    assert engine.callback_batches["kernel"] >= 3
    assert engine.callback_batches["loop"] == 0


def test_dbscan_on_the_loop_route_equals_the_kernel_route():
    X = _blobs_3d(6)
    _both(X, 0.015, 4, "fdbscan", engine=QueryEngine(EngineConfig(force="loop")))


@pytest.mark.parametrize("dim", [2, 3])
def test_dense_cells_match_reference(dim):
    rng = np.random.default_rng(20 + dim)
    X = (rng.integers(0, 8, (300, dim)) * 0.05
         + rng.uniform(0, 0.01, (300, dim))).astype(np.float32)
    for eps, min_pts in ((0.05, 3), (0.1, 6)):
        jl, jc = JD._dense_cells(jnp.asarray(X), jnp.float32(eps), min_pts)
        tl, tc = TD._dense_cells(torch.from_numpy(X), eps, min_pts)
        np.testing.assert_array_equal(np_of(tl), np.asarray(jl))
        np.testing.assert_array_equal(np_of(tc), np.asarray(jc))
        assert np_of(tc).any() and not np_of(tc).all()


def test_pointer_jump_core_matches_reference():
    rng = np.random.default_rng(30)
    n = 200
    labels = np.minimum(rng.integers(0, n, n), np.arange(n)).astype(np.int32)
    labels[rng.random(n) < 0.2] = TD._BIG
    want = JD._pointer_jump_core(jnp.asarray(labels))
    got = TD._pointer_jump_core(torch.from_numpy(labels))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_relabel_compact_and_bad_algorithm():
    lab = np.array([7, -1, 3, 7, 3, 12], np.int32)
    np.testing.assert_array_equal(TD.relabel_compact(torch.from_numpy(lab)),
                                  JD.relabel_compact(lab))
    with pytest.raises(ValueError, match="algorithm"):
        TD.dbscan(np.zeros((4, 2), np.float32), 0.1, 2, algorithm="optics",
                  policy=ExecutionPolicy(device=CPU))
