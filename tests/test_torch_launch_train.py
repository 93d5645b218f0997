"""PyTorch port vs the JAX package: the training driver
(``repro_torch.launch.train.main`` against ``repro.launch.train.main``)
on the TinyLlama smoke configuration, on the CPU.

The port starts from the reference's initial parameter tree
(``init_params``) and both print their per-step lines; the losses,
gradient norms and learning rates are compared as printed (the loss to
four decimals, the norm to three: the numbers agree to 1e-6, so they
match within one unit of the last printed digit). Resume: a run cut at
step 3 and resumed to 6 prints the uninterrupted run's later lines, in
each package, and the port resumes from the reference's checkpoint. The
sharded driver (``--model-parallel``) is held to the reference's in
``tests/test_torch_mesh_train.py``.
"""
import re

import jax
import numpy as np
import pytest
import torch

from test_torch_parity import one_torch_thread  # noqa: F401 (fixture)
from repro.configs import get_config as j_get_config
from repro.launch import train as JT
from repro.models import lm as JLM
from repro_torch.launch import train as TT

ARGS = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2", "--seq", "32",
        "--log-every", "1"]
LINE = re.compile(r"step\s+(\d+) loss=([\d.]+) gnorm=([\d.]+) lr=(\S+)")


def _init_tree(seed=0):
    cfg = j_get_config("tinyllama-1.1b", smoke=True)
    return jax.tree_util.tree_map(
        np.asarray, JLM.init_params(cfg, jax.random.PRNGKey(seed)))


def _run(capsys, main, argv, **kw):
    """(the printed step lines as (step, loss, gnorm, lr), all output)."""
    main(argv, **kw)
    out = capsys.readouterr().out
    return [(int(s), float(l), float(g), lr)
            for s, l, g, lr in LINE.findall(out)], out


def _port(capsys, argv, init=None):
    return _run(capsys, TT.main, ARGS + argv + ["--device", "cpu"],
                init_params=init)


def _ref(capsys, argv):
    return _run(capsys, JT.main, ARGS + argv)


def assert_same_lines(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= 1.5e-4, (g, w)
        assert abs(g[2] - w[2]) <= 1.5e-3, (g, w)
        assert g[3] == w[3], (g, w)


def test_main_matches_reference_and_resumes(capsys, tmp_path):
    want, ref_out = _ref(capsys, ["--steps", "6", "--ckpt-dir",
                                  str(tmp_path / "ref")])
    assert len(want) == 6
    got, out = _port(capsys, ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "port")], _init_tree())
    assert_same_lines(got, want)
    assert "tok/s" in out.splitlines()[-1] and out.startswith("step ")
    assert "straggler summary: {'n': 6," in out

    # cut at 3, resumed to 6: the uninterrupted run's later lines
    cut = str(tmp_path / "cut")
    first, _ = _port(capsys, ["--steps", "3", "--ckpt-dir", cut], _init_tree())
    assert first == got[:3]
    again, out = _port(capsys, ["--steps", "6", "--ckpt-dir", cut])
    assert "resumed from step 3" in out
    assert again == got[3:]

    # the port resumes the reference's cut run
    jcut = str(tmp_path / "jcut")
    jfirst, _ = _ref(capsys, ["--steps", "3", "--ckpt-dir", jcut])
    assert jfirst == want[:3]
    cross, out = _port(capsys, ["--steps", "6", "--ckpt-dir", jcut])
    assert "resumed from step 3" in out
    assert_same_lines(cross, want[3:])


def test_main_from_the_seed_without_checkpoints(capsys):
    lines, out = _port(capsys, ["--steps", "2", "--seed", "1"])
    assert [s for s, *_ in lines] == [0, 1]
    assert all(np.isfinite(l) for _, l, _, _ in lines)
    assert "resumed" not in out


def test_model_parallel_needs_the_sharding_slice():
    """--model-parallel k trains on launch.mesh's host mesh (the gloo
    worlds of tests/test_torch_mesh_train.py); a world of one process
    cannot split its model in two, and says so before any step."""
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        TT.main(ARGS + ["--steps", "1", "--device", "cpu",
                        "--model-parallel", "2"])


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(ARGS + ["--steps", "1"])
