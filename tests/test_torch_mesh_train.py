"""PyTorch port vs the JAX package on a mesh: sharded training
(``repro_torch.launch.train --model-parallel 2`` on 4 gloo ranks against
``repro.launch.train --model-parallel 2`` on 4 fake host devices, both
from the reference's ``init_params``), every family's sharded forward
against the port's unsharded one, and checkpoints across layouts.

One gloo world of 4 fresh processes, one of 2 (the "pod" axis's
compressed reduction) and one reference subprocess, started together in
a module fixture, do all the work; the tests compare what they saved.

Tolerances:
  * losses within 1e-5 relative: the sharded step reduces its partial
    sums (the data-parallel gradients, the row-parallel products, the
    vocabulary-parallel cross-entropy) over the mesh, in another float
    order than one device's or XLA's; each differs in the last bits;
  * parameters and AdamW moments within 1e-4 of a leaf's max |x| (as the
    unsharded training tests hold them);
  * logits within 1e-5 of max |logit|;
  * a resumed run's losses within 1e-5 relative of the uninterrupted
    run's (the layouts change the float order of the same sums).
"""
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from test_torch_parity import (WORLD_PRELUDE, assert_trees_close,  # noqa: F401
                               one_torch_thread, run_world, world_results)
from repro.configs import get_config as j_get_config
from repro.models import lm as JLM
from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch import train as TT

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARGS = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "4", "--seq", "32",
        "--log-every", "1"]
FAMILIES = ["tinyllama-1.1b", "phi3-mini-3.8b", "starcoder2-7b",
            "chatglm3-6b", "mixtral-8x22b", "deepseek-v3-671b",
            "mamba2-780m", "zamba2-7b", "seamless-m4t-medium",
            "llava-next-mistral-7b"]
#: configurations whose kv heads do not divide a 2-wide "model" axis:
#: one kv head (every query head reads it), 6 query heads over 3 kv heads
#: (rank 0's heads 0-2 read kv heads 0, 0, 1: no even grouping), and 3
#: query heads, which the axis splits unevenly (starcoder2's 36 over 16)
KV_REPLICATED = {"mqa": dict(n_kv_heads=1),
                 "uneven": dict(n_heads=6, n_kv_heads=3, head_dim=16),
                 "odd_heads": dict(n_heads=3, n_kv_heads=1, head_dim=16)}
MOE_IMPLS = ["gather", "ragged"]

REF_CODE = """
import builtins, json, sys
from repro.launch import train as JT
got = []

def rec(x):
    got.append(builtins.float(x))
    return got[-1]

JT.float = rec
JT.main({args!r})
print("RECORD", json.dumps(got))
"""

WORLD_CODE = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M, sharding as SH
from repro_torch.launch import train as TT
from repro_torch.models.layers import cross_entropy, set_sharding_rules
from repro_torch.models.lm import LM

def tree_of(path):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out

def recorded(argv, **kw):
    got, orig = [], TT._value
    def rec(t):
        got.append(orig(t))
        return got[-1]
    TT._value = rec
    try:
        got.append(TT.main(argv, **kw))
    finally:
        TT._value = orig
    return got

ARGS = %(args)r
BASE = %(base)r
train = recorded(ARGS + ["--steps", "3", "--model-parallel", "2",
                         "--device", "cpu", "--ckpt-dir", BASE + "/port"],
                 init_params=tree_of(BASE + "/init.npz"))
resumed = recorded(ARGS + ["--steps", "4", "--model-parallel", "2",
                           "--device", "cpu", "--ckpt-dir", BASE + "/plain"])
micro = recorded(ARGS + ["--steps", "2", "--n-micro", "2",
                         "--model-parallel", "2", "--device", "cpu"],
                 init_params=tree_of(BASE + "/init.npz"))
# 4 microbatches over the 2 rows a data rank holds: 2 of one row a rank
micro4 = recorded(ARGS + ["--steps", "2", "--n-micro", "4",
                          "--model-parallel", "2", "--device", "cpu",
                          "--ckpt-dir", BASE + "/micro4"],
                  init_params=tree_of(BASE + "/init.npz"))

errs = {}
mesh = M.make_host_mesh(2, "cpu")
cases = [(a, {}) for a in %(families)r]
cases += [("tinyllama-1.1b", o) for o in %(kv)r.values()]
cases += [("mixtral-8x22b", {"moe_impl": m}) for m in %(moe)r]
cases += [("deepseek-v3-671b", {"moe_impl": m}) for m in %(moe)r]
for i, (arch, over) in enumerate(cases):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    g = torch.Generator().manual_seed(i)
    B = 4
    tok = torch.randint(0, cfg.vocab, (B, 16), generator=g)
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = torch.randn(B, cfg.n_patches, cfg.d_model,
                                         generator=g)
    if cfg.family == "encdec":
        kw["src_embeds"] = torch.randn(B, 8, cfg.d_model, generator=g)
    with torch.no_grad():
        want, _ = LM.from_config(cfg, 0, "cpu")(tok, **kw)
        model = LM.from_config(cfg, 0, "cpu")
        SH.distribute_model(model, mesh, SH.param_specs(model, mesh))
        set_sharding_rules(SH.logical_rules(mesh), mesh)
        try:
            bs = SH.batch_spec(mesh, B)
            got, _ = model(SH.to_dtensor(tok, mesh, bs),
                           **{k: SH.to_dtensor(v, mesh, bs)
                              for k, v in kw.items()})
            got = got.full_tensor()
        finally:
            set_sharding_rules(None)
    errs[f"{i}"] = float((got - want).abs().max() / want.abs().max())
# the kv-replicated layouts' gradients, sharded against plain
for j, over in enumerate(%(kv)r.values()):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              **over)
    tok = torch.randint(0, cfg.vocab, (4, 16),
                        generator=torch.Generator().manual_seed(50 + j))
    lab = torch.roll(tok, -1, 1)
    plain = LM.from_config(cfg, 0, "cpu")
    names = [n for n, _ in plain.named_parameters()]
    want = torch.autograd.grad(cross_entropy(plain(tok)[0], lab),
                               list(plain.parameters()))
    model = LM.from_config(cfg, 0, "cpu")
    SH.distribute_model(model, mesh, SH.param_specs(model, mesh))
    set_sharding_rules(SH.logical_rules(mesh), mesh)
    try:
        bs = SH.batch_spec(mesh, 4)
        loss = cross_entropy(model(SH.to_dtensor(tok, mesh, bs))[0],
                             SH.to_dtensor(lab, mesh, bs))
        got = torch.autograd.grad(loss, list(model.parameters()))
        errs[f"grad{j}"] = max(float((g.full_tensor() - w).abs().max()
                                     / w.abs().max())
                               for g, w in zip(got, want))
    finally:
        set_sharding_rules(None)
if RANK == 0:
    with open(OUT + "/record.json", "w") as f:
        json.dump({"train": train, "resumed": resumed, "micro": micro,
                   "micro4": micro4, "fwd": errs}, f)
save(rank_last=np.array(train[-1]))
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_lines(argv, init=None):
    """The port's recorded (loss, gnorm, lr) values of an unsharded run."""
    got, orig = [], TT._value

    def rec(t):
        got.append(orig(t))
        return got[-1]

    TT._value = rec
    try:
        TT.main(ARGS + argv + ["--device", "cpu"], init_params=init)
    finally:
        TT._value = orig
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mesh"))
    cfg = j_get_config("tinyllama-1.1b", smoke=True)
    init = jax.tree_util.tree_map(
        np.asarray, JLM.init_params(cfg, jax.random.PRNGKey(0)))
    np.savez(os.path.join(base, "init.npz"), **_flat(init))
    # an unsharded run cut at step 2, which the world resumes sharded
    cut = _port_lines(["--steps", "2", "--ckpt-dir",
                       os.path.join(base, "plain")], init)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE.format(args=ARGS + [
            "--steps", "3", "--model-parallel", "2", "--ckpt-dir",
            os.path.join(base, "ref")])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pods = os.path.join(base, "pods")
    os.makedirs(pods)
    pod_fail = []

    def pod_world():
        try:
            run_world(POD_CODE, 2, timeout=420, out=pods)
        except AssertionError as e:
            pod_fail.append(str(e))

    pod = threading.Thread(target=pod_world)
    pod.start()
    try:
        run_world(WORLD_CODE % {"args": ARGS, "base": base,
                                "families": FAMILIES, "kv": KV_REPLICATED,
                                "moe": MOE_IMPLS},
                  4, timeout=420, out=base)
        out, err = ref.communicate(timeout=420)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        pod.join(timeout=450)
    assert not pod.is_alive() and not pod_fail, pod_fail
    assert ref.returncode == 0, err
    ref_rec = json.loads(out.split("RECORD", 1)[1].strip().splitlines()[0])
    with open(os.path.join(base, "record.json")) as f:
        rec = json.load(f)
    return {"base": base, "init": init, "ref": ref_rec, "port": rec,
            "cut": cut, "ranks": world_results(base, 4),
            "pods": world_results(pods, 2)}


def _losses(record, steps):
    """The loss of each logged step: every third recorded value (loss,
    gnorm, lr)."""
    return record[0:3 * steps:3]


def test_sharded_training_matches_the_reference_losses(runs):
    got, want = _losses(runs["port"]["train"], 3), _losses(runs["ref"], 3)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the norms and learning rates the lines print
    np.testing.assert_allclose(runs["port"]["train"][1:9:3],
                               runs["ref"][1:9:3], rtol=1e-5)
    assert runs["port"]["train"][2:9:3] == pytest.approx(
        runs["ref"][2:9:3], rel=1e-6)
    # every rank returned the same last loss
    for r in runs["ranks"]:
        assert float(r["rank_last"]) == got[-1]


def test_sharded_training_matches_the_reference_state(runs):
    step, got, _ = load_checkpoint(os.path.join(runs["base"], "port",
                                                "step_000003"))
    rstep, want, _ = load_checkpoint(os.path.join(runs["base"], "ref",
                                                  "step_000003"))
    assert step == rstep == 3
    assert_trees_close(got["params"], want["params"], 1e-4, "params")
    for key in ("m", "v"):
        assert_trees_close(got["opt"][key], want["opt"][key], 1e-4, key)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3


@pytest.mark.parametrize("case", range(len(FAMILIES) + len(KV_REPLICATED)
                                       + 2 * len(MOE_IMPLS)))
def test_sharded_forward_matches_unsharded(runs, case):
    """Every family's smoke forward on a 2 x 2 world (batch over "data",
    heads, ffn and vocabulary over "model"), the kv-replicated
    configurations and the MoE's gather and ragged dispatch."""
    err = runs["port"]["fwd"][str(case)]
    assert err <= 1e-5, (case, err)


@pytest.mark.parametrize("case", range(len(KV_REPLICATED)))
def test_sharded_gradients_of_replicated_kv_layouts(runs, case):
    """The kv-replicated and unevenly split head layouts' gradients on the
    2 x 2 world (the kv gradient a partial sum over "model", the gathered
    heads' views held whole) within 1e-4 of each leaf's max."""
    err = runs["port"]["fwd"][f"grad{case}"]
    assert err <= 1e-4, (case, err)


def test_unsharded_checkpoint_resumes_sharded(runs):
    """A run cut unsharded at step 2, resumed on the mesh to step 4, gives
    the uninterrupted unsharded run's later losses."""
    whole = _port_lines(["--steps", "4"], runs["init"])
    got = runs["port"]["resumed"]
    np.testing.assert_allclose(_losses(got, 2), _losses(whole[6:], 2),
                               rtol=1e-5)
    np.testing.assert_allclose(_losses(runs["cut"], 2), _losses(whole, 2),
                               rtol=0)


def test_sharded_microbatches_match_unsharded(runs):
    """--n-micro 2 on the mesh splits each rank's own rows (the reference
    splits the global rows): every row has as many labels, so the summed
    gradient and the losses are the unsharded run's."""
    whole = _port_lines(["--steps", "2", "--n-micro", "2"], runs["init"])
    np.testing.assert_allclose(_losses(runs["port"]["micro"], 2),
                               _losses(whole, 2), rtol=1e-5)


def test_sharded_microbatches_past_a_ranks_rows_match_unsharded(runs,
                                                               tmp_path):
    """--n-micro 4 on the mesh, whose data ranks hold 2 rows each, runs 2
    microbatches of one row a rank (the reference splits the 4 global rows
    into 4): the losses, gradient norms and the state after 2 steps are
    the unsharded --n-micro 4 run's, losses and norms within 1e-5
    relative, parameters and moments within 1e-4 of a leaf's max."""
    whole = _port_lines(["--steps", "2", "--n-micro", "4", "--ckpt-dir",
                         str(tmp_path)], runs["init"])
    got = runs["port"]["micro4"]
    np.testing.assert_allclose(_losses(got, 2), _losses(whole, 2), rtol=1e-5)
    np.testing.assert_allclose(got[1:6:3], whole[1:6:3], rtol=1e-5)
    _, mine, _ = load_checkpoint(os.path.join(runs["base"], "micro4",
                                              "step_000002"))
    _, plain, _ = load_checkpoint(os.path.join(str(tmp_path), "step_000002"))
    assert_trees_close(mine["params"], plain["params"], 1e-4, "params")
    for key in ("m", "v"):
        assert_trees_close(mine["opt"][key], plain["opt"][key], 1e-4, key)


ONE_RANK = """
from repro_torch.configs import get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.layers import set_sharding_rules
from repro_torch.models.lm import LM
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step

cfg = get_config("tinyllama-1.1b", smoke=True)
tok = torch.randint(0, cfg.vocab, (2, 16),
                    generator=torch.Generator().manual_seed(7))
batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
plain = LM.from_config(cfg, 0, "cpu")
popt = adamw_init(plain)
pstep = make_train_step(cfg, n_micro=2)
mesh = make_host_mesh(1, "cpu")
model = LM.from_config(cfg, 0, "cpu")
set_sharding_rules(SH.logical_rules(mesh), mesh)
pspecs = SH.param_specs(model, mesh)
SH.distribute_model(model, mesh, pspecs)
opt = adamw_init(model, mesh=mesh, specs=SH.zero1_specs(pspecs, model, mesh))
step = make_train_step(cfg, n_micro=4)    # 4 > the 2 rows the rank holds
bs = SH.batch_spec(mesh, 2)
gaps = {"loss": []}
for _ in range(2):
    want = float(pstep(plain, popt, batch)["loss"])
    got = float(step(model, opt, {k: SH.to_dtensor(v, mesh, bs)
                                  for k, v in batch.items()})["loss"]
                .full_tensor())
    gaps["loss"].append(abs(got - want))
set_sharding_rules(None)
pp = dict(plain.named_parameters())
gaps["params"] = max(float((p.to_local() - pp[n]).abs().max())
                     for n, p in model.named_parameters())
gaps["moments"] = max(float((opt[key][n].to_local() - popt[key][n])
                            .abs().max())
                      for key in ("m", "v") for n in pp)
save(**{k: np.asarray(v) for k, v in gaps.items()})
"""


def test_microbatches_past_a_ranks_rows_on_one_rank():
    """A (1, 1) mesh of one gloo rank holding 2 rows with --n-micro 4: two
    microbatches of one row, the unsharded n_micro = 2 step's split. The
    losses, parameters and AdamW moments after 2 steps equal the
    unsharded step's exactly (the smoke's MESH_A_TOL, 0)."""
    import tempfile
    out = tempfile.mkdtemp(prefix="one-rank-")
    run_world(ONE_RANK, 1, timeout=300, out=out)
    got = world_results(out, 1)[0]
    assert got["loss"].tolist() == [0.0, 0.0]
    assert float(got["params"]) == 0.0 and float(got["moments"]) == 0.0


def test_sharded_checkpoint_resumes_unsharded(runs, capsys):
    """The sharded run's step-3 checkpoint resumed by one process to step
    5 gives the uninterrupted unsharded run's losses of steps 3 and 4."""
    whole = _port_lines(["--steps", "5"], runs["init"])
    again = _port_lines(["--steps", "5", "--ckpt-dir",
                         os.path.join(runs["base"], "port")])
    assert "resumed from step 3" in capsys.readouterr().out
    np.testing.assert_allclose(_losses(again, 2), _losses(whole[9:], 2),
                               rtol=1e-5)


POD_CODE = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.data import synthetic_batch
from repro_torch.launch import mesh as M, sharding as SH
from repro_torch.models.layers import set_sharding_rules
from repro_torch.models.lm import LM
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step
cfg = get_config("tinyllama-1.1b", smoke=True)
batches = [synthetic_batch(0, s, 4, 16, cfg.vocab, device="cpu")
           for s in range(2)]
step = make_train_step(cfg, grad_compression=True,
                       pod_group=dist.group.WORLD)
# the plain path: each rank its half of the batch, the summands all-reduced
plain = LM.from_config(cfg, 0, "cpu")
popt = adamw_init(plain)
for b in batches:
    step(plain, popt, {k: v[2 * RANK:2 * RANK + 2] for k, v in b.items()})
# the mesh: ("pod", "data", "model") = (2, 1, 1), the pod's group
mesh = M.make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
model = LM.from_config(cfg, 0, "cpu")
set_sharding_rules(SH.logical_rules(mesh), mesh)
pspecs = SH.param_specs(model, mesh)
ospecs = SH.zero1_specs(pspecs, model, mesh)
SH.distribute_model(model, mesh, pspecs)
opt = adamw_init(model, mesh=mesh, specs=ospecs)
step = make_train_step(cfg, grad_compression=True,
                       pod_group=mesh.get_group("pod"))
for b in batches:
    m = step(model, opt, {k: SH.to_dtensor(v, mesh, SH.batch_spec(mesh, 4))
                          for k, v in b.items()})
gap = 0.0
for n, p in plain.named_parameters():
    q = dict(model.named_parameters())[n].full_tensor()
    gap = max(gap, float((q - p).abs().max() / p.abs().max()))
err = max(float((opt["ef_err"][n].to_local() - popt["ef_err"][n] / 2)
                .abs().max()) for n in popt["ef_err"])
save(rank_gap=np.array(gap), rank_err=np.array(err))
"""


def test_pod_compression_on_the_mesh_matches_the_plain_reduction(runs):
    """``make_train_step(pod_group=mesh.get_group("pod"))`` on a (2, 1, 1)
    ("pod", "data", "model") mesh against the plain path's compressed
    all-reduce over 2 ranks, each rank half the batch, over two steps:
    the mesh quantizes its pod's partial sum (half the plain summand,
    which int8 quantizes to the same codes at half the scale) and adds
    the pods' summands; the weights agree within float32 rounding of the
    plain path's, the error feedback is half the plain one's."""
    for r in runs["pods"]:
        assert float(r["rank_gap"]) <= 1e-6, float(r["rank_gap"])
        assert float(r["rank_err"]) <= 1e-7, float(r["rank_err"])
