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

import os
import shutil
import subprocess
import sys
import tempfile
import time

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


#: what every rank of a ``run_world`` world runs before its code: one
#: thread, a gloo group over a file store, RANK / RANKS / OUT, and
#: ``save(**arrays)`` writing OUT/rank<RANK>.npz
WORLD_PRELUDE = """
import datetime, os, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, RANKS = int(os.environ["REPRO_RANK"]), int(os.environ["REPRO_RANKS"])
OUT = os.environ["REPRO_OUT"]
dist.init_process_group(
    "gloo", init_method="file://" + os.environ["REPRO_STORE"], rank=RANK,
    world_size=RANKS, timeout=datetime.timedelta(seconds=60))

def save(**arrays):
    np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **arrays)
"""


def run_world(code: str, ranks: int, timeout: float = 120.0,
              out: str | None = None, env: dict | None = None) -> list[str]:
    """Run `code` in `ranks` fresh processes joined in one gloo group over
    a file store (the port's counterpart of ``conftest.run_subprocess``
    with fake host devices); every rank runs ``WORLD_PRELUDE`` first.
    Results go to `out` (a directory: OUT/rank<r>.npz through ``save``;
    by default a fresh one, kept, else the work directory is removed).
    Returns each rank's stdout; raises AssertionError when a rank fails or
    the world outlives `timeout` (every process is killed then)."""
    work = tempfile.mkdtemp(prefix="world-")
    out = out or work
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    base.update(REPRO_RANKS=str(ranks), REPRO_OUT=out,
                REPRO_STORE=os.path.join(work, "store"))
    logs = [(open(os.path.join(work, f"out{r}"), "w+"),
             open(os.path.join(work, f"err{r}"), "w+")) for r in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD_PRELUDE + code],
        env=dict(base, REPRO_RANK=str(r)), stdout=so, stderr=se, text=True)
        for r, (so, se) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        failed.append(f"the world outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        so.seek(0)
        se.seek(0)
        outs.append(so.read())
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}:\n{se.read()}")
        so.close()
        se.close()
    if out != work:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def world_results(out: str, ranks: int) -> list[dict]:
    """Each rank's saved arrays."""
    parts = []
    for r in range(ranks):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            parts.append({k: z[k] for k in z.files})
    return parts


def merge_ranks(parts: list[dict]) -> dict:
    """The ranks' saved results as one global result: per-query arrays
    concatenated in rank order, CSR pairs (``*_off`` with ``*_idx`` /
    ``*_val``) with their offsets shifted, and replicated keys
    (``rep_*``, ``err_*``) checked equal on every rank; ``rank_*`` keys
    (each rank's own) stacked."""
    out = {}
    for key in parts[0]:
        vals = [p[key] for p in parts]
        if key.startswith("rank_"):
            out[key] = np.stack(vals)
        elif key.startswith(("rep_", "err_")):
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            out[key] = vals[0]
        elif key.endswith("_off"):
            offs, at = [np.zeros(1, np.int32)], 0
            for v in vals:
                offs.append(v[1:] + at)
                at += int(v[-1])
            out[key] = np.concatenate(offs)
        else:
            out[key] = np.concatenate(vals)
    return out


def flat_tree(tree: dict, prefix=()) -> dict:
    """A nested dict of arrays (a parameter, gradient or optimizer tree)
    as {path tuple: float32 numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def assert_trees_close(got: dict, want: dict, tol: float, label=""):
    """Two trees with the same paths, every leaf of `got` within `tol` of
    its `want` leaf's max |x| (0 means equal)."""
    got, want = flat_tree(got), flat_tree(want)
    assert sorted(got) == sorted(want), label
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path] - w).max())
        assert err <= tol * scale, (label, path, err, scale)


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


def test_merge_ranks_shifts_csr_and_checks_replicas():
    parts = [{"a_off": np.array([0, 2, 3], np.int32), "a_idx": np.arange(3),
              "d": np.array([1.0, 2.0]), "rep_x": np.array(7),
              "rank_p": np.array([r, r])} for r in range(2)]
    got = merge_ranks(parts)
    np.testing.assert_array_equal(got["a_off"], [0, 2, 3, 5, 6])
    np.testing.assert_array_equal(got["a_idx"], [0, 1, 2, 0, 1, 2])
    np.testing.assert_array_equal(got["d"], [1.0, 2.0, 1.0, 2.0])
    np.testing.assert_array_equal(got["rank_p"], [[0, 0], [1, 1]])
    assert got["rep_x"] == 7
    parts[1]["rep_x"] = np.array(8)
    with pytest.raises(AssertionError):
        merge_ranks(parts)


def test_run_world_fails_when_a_rank_fails(tmp_path):
    code = ("t = torch.tensor([RANK])\n"
            "dist.all_reduce(t)\n"
            "assert RANK == 0, 'rank %d fails' % RANK\n"
            "save(t=t.numpy())\n")
    with pytest.raises(AssertionError, match="rank 1 fails"):
        run_world(code, 2, timeout=60, out=str(tmp_path))
    assert os.listdir(tmp_path) == ["rank0.npz"]
    assert world_results(str(tmp_path), 1)[0]["t"].tolist() == [1]
