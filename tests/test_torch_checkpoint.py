"""PyTorch port vs the JAX package: checkpoints, data and the straggler
monitor (``repro_torch.checkpoint``, ``repro_torch.data``,
``repro_torch.train.straggler``).

* the checkpoint layout (``step_XXXXXX/``, ``arrays.npz``,
  ``manifest.json``, ``COMMITTED``, keys joined by ``|``), round trip,
  retention, the async writer's snapshot, a write error raised by
  ``wait()``;
* a checkpoint of each package restored by the other, the LM's and the
  optimizer's trees through ``convert``;
* bfloat16: the port writes a bf16 leaf as float32 and restores it as
  bf16; it reads the reference's ``|V2`` entries as bf16 bits; the
  reference cannot restore its own bf16 checkpoint (pinned here: the
  ``ValueError`` its launcher's ``jnp.asarray(b, a.dtype)`` raises);
* ``synthetic_batch``, ``TokenPipeline`` (resume, host shards) and
  ``point_cloud`` bit for bit against ``repro.data``;
* ``StragglerMonitor`` with a scripted clock.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import flat_tree as flat
from test_torch_parity import one_torch_thread  # noqa: F401 (fixture)
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_checkpoint as j_load
from repro.configs import get_config as j_get_config
from repro.data import TokenPipeline as JPipeline
from repro.data import point_cloud as j_point_cloud
from repro.data import synthetic_batch as j_synthetic_batch
from repro.models import lm as JLM
from repro.optim import adamw_init as j_adamw_init
from repro_torch import LM, convert, get_config
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import TokenPipeline, point_cloud, synthetic_batch
from repro_torch.optim import adamw_init
from repro_torch.train import StragglerMonitor


def _model(dtype="float32", seed=0):
    import dataclasses
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              dtype=dtype)
    return LM.from_config(cfg, seed=seed, device="cpu")


# ---------------------------------------------------------------------------
# the format, round trip, retention
# ---------------------------------------------------------------------------

def test_layout_round_trip_and_retention(tmp_path):
    model = _model()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for s in (5, 10, 15):
        mgr.save(s, {"params": convert.lm_to_numpy(model)},
                 extra={"note": s})
    mgr.wait()
    assert mgr.all_steps() == [10, 15] and mgr.latest_step() == 15
    assert sorted(os.listdir(tmp_path)) == ["step_000010", "step_000015"]
    d = tmp_path / "step_000015"
    assert sorted(os.listdir(d)) == ["COMMITTED", "arrays.npz",
                                     "manifest.json"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 15 and manifest["extra"] == {"note": 15}
    assert "params|layers|attn|wq" in manifest["keys"]
    assert manifest["keys"] == sorted(manifest["keys"])
    step, tree, extra = mgr.restore()
    assert step == 15 and extra == {"note": 15}
    back = convert.lm_from_numpy(model.cfg, tree["params"], "cpu")
    for (n, a), b in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(a, b), n
    # a step directory without COMMITTED is not a checkpoint
    os.makedirs(tmp_path / "step_000020")
    assert mgr.all_steps() == [10, 15]
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_save_snapshots_before_later_updates(tmp_path):
    """The async writer holds host copies taken at save(): updates of the
    tensors in place afterwards do not reach the checkpoint."""
    w = torch.arange(6, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path), keep=0)
    mgr.save(1, {"w": w, "n": np.arange(3)})
    w.add_(100.0)
    mgr.wait()
    _, tree, _ = mgr.restore(1)
    np.testing.assert_array_equal(tree["w"], np.arange(6, dtype=np.float32))


def test_write_errors_are_raised_by_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr("repro_torch.checkpoint.manager._write", broken)
    mgr.save(1, {"x": np.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()


def test_load_onto_a_device_gives_tensors(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.int32),
            "b": {"c": torch.ones(2, 3)}}
    save_checkpoint(str(tmp_path), 3, tree)
    step, host, _ = load_checkpoint(str(tmp_path))
    assert step == 3 and isinstance(host["b"]["c"], np.ndarray)
    _, dev, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert dev["a"].dtype == torch.int32 and torch.equal(dev["a"], tree["a"])
    assert torch.equal(dev["b"]["c"], tree["b"]["c"])


# ---------------------------------------------------------------------------
# each package restores the other's checkpoint
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg = j_get_config("starcoder2-7b", smoke=True)
    params = JLM.init_params(cfg, jax.random.PRNGKey(1))
    opt = j_adamw_init(params)
    opt = dict(opt, step=jnp.int32(7),
               m=jax.tree_util.tree_map(lambda p: p * 0.5, params))
    mgr = JManager(str(tmp_path), keep=1, async_write=False)
    mgr.save(7, {"params": params, "opt": opt})
    step, tree, _ = CheckpointManager(str(tmp_path)).restore()
    assert step == 7
    model = convert.lm_from_numpy(get_config("starcoder2-7b", smoke=True),
                                  tree["params"], "cpu")
    state = convert.opt_from_numpy(model, tree["opt"])
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
    want = flat(jax.tree_util.tree_map(np.asarray, params))
    for path, a in flat(convert.lm_to_numpy(model)).items():
        np.testing.assert_array_equal(a, want[path])
    for path, a in flat(convert.opt_to_numpy(state)["m"]).items():
        np.testing.assert_array_equal(a, 0.5 * want[path])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The reference's loader and its launcher's tree_map over a fresh
    init (the structures must match) take the port's checkpoint."""
    model = _model(seed=4)
    state = adamw_init(model)
    state["step"] += 3
    with torch.no_grad():
        for n, m in state["m"].items():
            m.copy_(dict(model.named_parameters())[n] * 2)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, {"params": convert.lm_to_numpy(model),
                 "opt": convert.opt_to_numpy(state)})
    step, tree, _ = j_load(str(tmp_path / "step_000003"))
    assert step == 3
    cfg = j_get_config("tinyllama-1.1b", smoke=True)
    params = JLM.init_params(cfg, jax.random.PRNGKey(0))
    restored = jax.tree_util.tree_map(lambda a, b: jnp.asarray(b, a.dtype),
                                      params, tree["params"])
    opt = jax.tree_util.tree_map(lambda a, b: jnp.asarray(b, a.dtype),
                                 j_adamw_init(params), tree["opt"])
    assert int(opt["step"]) == 3
    want = flat(convert.lm_to_numpy(model))
    for path, a in flat(jax.tree_util.tree_map(np.asarray,
                                               restored)).items():
        np.testing.assert_array_equal(a, want[path])
        np.testing.assert_array_equal(flat(jax.tree_util.tree_map(
            np.asarray, opt["m"]))[path], 2 * want[path])


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

def test_port_bf16_round_trip(tmp_path):
    """bf16 tensors are written as float32 (exact), noted in the manifest,
    and come back as bf16 on a device, as float32 on the host."""
    model = _model("bfloat16", seed=2)
    named = dict(model.named_parameters())
    save_checkpoint(str(tmp_path), 1, {"params": named})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["dtypes"]["params|layers.0.attn.wq"] == "bfloat16"
    assert "params|layers.0.ln1.scale" not in manifest["dtypes"]
    with np.load(tmp_path / "arrays.npz") as z:
        assert z["params|embed.table"].dtype == np.float32
    _, dev, _ = load_checkpoint(str(tmp_path), device="cpu")
    for n, p in named.items():
        assert dev["params"][n].dtype == p.dtype and torch.equal(
            dev["params"][n], p.detach()), n
    _, host, _ = load_checkpoint(str(tmp_path))
    assert host["params"]["embed.table"].dtype == np.float32
    np.testing.assert_array_equal(host["params"]["embed.table"],
                                  named["embed.table"].detach().float())


def test_port_resumes_its_own_bf16_model(tmp_path):
    model = _model("bfloat16", seed=5)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"params": convert.lm_to_numpy(model)})
    _, tree, _ = mgr.restore()
    back = convert.lm_from_numpy(model.cfg, tree["params"], "cpu")
    for (n, a), b in zip(model.named_parameters(), back.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def _reference_bf16_checkpoint(tmp_path):
    import dataclasses
    cfg = dataclasses.replace(j_get_config("tinyllama-1.1b", smoke=True),
                              dtype="bfloat16")
    params = JLM.init_params(cfg, jax.random.PRNGKey(3))
    JManager(str(tmp_path), async_write=False).save(4, {"params": params})
    return cfg, params


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """The reference defect the port departs from: ``np.savez`` writes a
    bf16 leaf as raw ``|V2`` bytes, and the launcher's restore
    (``jnp.asarray(b, a.dtype)``) raises."""
    cfg, params = _reference_bf16_checkpoint(tmp_path)
    _, tree, _ = JManager(str(tmp_path)).restore()
    assert tree["params"]["embed"]["table"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="No cast function"):
        jax.tree_util.tree_map(lambda a, b: jnp.asarray(b, a.dtype), params,
                               tree["params"])


def test_port_reads_the_reference_bf16_checkpoint(tmp_path):
    """The port takes a ``|V2`` entry as bf16 bits: the reference's
    weights exactly."""
    cfg, params = _reference_bf16_checkpoint(tmp_path)
    _, tree, _ = CheckpointManager(str(tmp_path)).restore()
    tcfg = __import__("dataclasses").replace(
        get_config("tinyllama-1.1b", smoke=True), dtype="bfloat16")
    model = convert.lm_from_numpy(tcfg, tree["params"], "cpu")
    want = flat(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params))
    for path, a in flat(convert.lm_to_numpy(model)).items():
        np.testing.assert_array_equal(a, want[path])
    _, dev, _ = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert dev["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    # the float32 norms stay float32
    assert dev["params"]["layers"]["ln1"]["scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_batch_matches_reference():
    for seed, step in ((0, 0), (3, 17), (11, 2)):
        want = j_synthetic_batch(seed, step, 3, 9, 101, np_out=True)
        got = synthetic_batch(seed, step, 3, 9, 101, np_out=True)
        mine = synthetic_batch(seed, step, 3, 9, 101, device="cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert mine[k].dtype == torch.int64
            np.testing.assert_array_equal(mine[k].numpy(), want[k])
        assert (want["labels"][:, -1] == -100).all()


def test_pipeline_resume_exactness_against_reference():
    ref = JPipeline(seed=3, batch=4, seq=16, vocab=100)
    ref_batches = [ref.next() for _ in range(5)]
    p1 = TokenPipeline(seed=3, batch=4, seq=16, vocab=100, device="cpu")
    batches = [p1.next() for _ in range(5)]
    for a, b in zip(batches, ref_batches):
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int64 and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    p2 = TokenPipeline(seed=3, batch=4, seq=16, vocab=100,
                       device="cpu").restore(3)
    assert torch.equal(p2.next()["tokens"], batches[3]["tokens"])
    assert p2.step == 4


def test_pipeline_host_shards_against_reference():
    for host in range(2):
        ref = JPipeline(seed=1, batch=6, seq=8, vocab=50, host_index=host,
                        host_count=2)
        ours = TokenPipeline(seed=1, batch=6, seq=8, vocab=50,
                             host_index=host, host_count=2, device="cpu")
        for _ in range(2):
            a, b = ours.next(), ref.next()
            assert a["tokens"].shape == (3, 8)
            np.testing.assert_array_equal(a["labels"].numpy(),
                                          np.asarray(b["labels"]))


def test_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(seed=0, batch=1, seq=2, vocab=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_batch(0, 0, 1, 2, 3)


@pytest.mark.parametrize("kind", ["uniform", "normal", "clusters",
                                  "filaments"])
def test_point_cloud_matches_reference(kind):
    got = point_cloud(kind, 5000, dim=3, seed=4)
    assert got.dtype == np.float32 and got.shape == (5000, 3)
    np.testing.assert_array_equal(got, j_point_cloud(kind, 5000, 3, 4))
    with pytest.raises(ValueError):
        point_cloud("spiral", 10)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_monitor_detects_slow_steps(monkeypatch):
    from repro.train import straggler as JS
    from repro_torch.train import straggler as S
    runs = []
    for mod in (S, JS):
        now = [0.0]
        monkeypatch.setattr(mod.time, "perf_counter", lambda: now[0])
        mon = mod.StragglerMonitor(window=20, threshold=2.0, sustained=3)
        actions = []
        for i, dt in enumerate([0.001] * 15 + [0.02] * 4 + [0.001] * 2
                               + [0.05]):
            mon.start()
            now[0] += dt
            actions.append(mon.stop(i))
        runs.append((actions, mon.events, mon.summary()))
    assert runs[0] == runs[1]
    actions, events, summary = runs[0]
    assert actions[:15] == [None] * 15
    assert actions[15:19] == ["warn", "checkpoint", "rebalance", "rebalance"]
    assert summary["events"] == len(events) >= 4
    assert StragglerMonitor().summary() == {}
