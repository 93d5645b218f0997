"""PyTorch port vs the JAX package: the LM's loss, its gradients and the
train step (``repro_torch.models.lm.loss_fn``, ``layers.cross_entropy``,
``layers._RMSNorm``, per-layer remat, ``train.step``).

* ``cross_entropy`` with masked (-100) and clipped labels, and
  ``_RMSNorm``'s backward against ``jax.vjp`` of the reference's custom
  VJP in float32 and bfloat16;
* ``loss_fn`` and every gradient for the ten smoke configurations
  (DeepSeek's MTP loss and both MoE losses included), with remat off and
  on, against ``jax.value_and_grad`` of ``repro.models.lm.loss_fn`` on the
  same weights (``convert.lm_to_numpy`` / ``grads_to_numpy``), and a
  bfloat16 TinyLlama;
* the train step against the reference's ``make_train_step`` over two
  steps, ``n_micro`` in {1, 2, 4}, the fixed-batch loss drop and the eval
  step.

Tolerances: float32 losses within 1e-5 relative and every gradient leaf
within 1e-4 of its max |g| (the sums run in other orders in each
framework: about 1e-6 of the scale). No MoE
family needs more: the router's top-k picks the same experts in both on
these inputs, so the dispatch is the same. bfloat16 TinyLlama 2e-2 (every
product and activation rounded to 2^-8, at other places in each
framework). After two optimizer steps the parameters within 1e-5 of
each leaf's max |p| plus 1e-2 lr (at step 1 the update is lr times
g / (|g| + eps), whose sign a gradient near zero may flip).
"""
import ast
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import (assert_trees_close, np_of,  # noqa: F401
                               one_torch_thread, flat_tree as flat)
from repro import configs as JC
from repro.data import synthetic_batch as j_synthetic_batch
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.optim import adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
from repro_torch import LM, convert, get_config
from repro_torch.data import synthetic_batch
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TADAMW
from repro_torch.optim import compression as TCOMP
from repro_torch.optim import adamw_init
from repro_torch.train import make_eval_step, make_train_step
from repro_torch.train import step as TSTEP

ARCHS = sorted(JC.ARCHS)
LOSS_RTOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2


def t_of(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_cross_entropy_masked_and_clipped_labels():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    labels[2, 6] = -100
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = TL.cross_entropy(t_of(logits), t_of(labels.astype(np.int64)))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    # every label masked: the sum over max(count, 1), 0 in both
    none = np.full((3, 7), -100, np.int32)
    assert float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(none))) \
        == float(TL.cross_entropy(t_of(logits), t_of(none))) == 0.0
    # bf16 logits are summed in float32
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    wb = float(JL.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                jnp.asarray(labels)))
    assert abs(float(TL.cross_entropy(lb, t_of(labels))) - wb) <= 1e-6 * wb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_the_reference_vjp(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 48)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    g = rng.normal(size=(2, 5, 48)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda a, s: JL._rmsnorm(a, s, 1e-6),
                       jnp.asarray(x, jdt), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx = t_of(x).to(tdt).requires_grad_()
    ts = t_of(scale).requires_grad_()
    tout = TL.rms_norm(tx, ts)
    assert tout.grad_fn.name().endswith("_RMSNormBackward")
    dx, ds = torch.autograd.grad(tout, (tx, ts), t_of(g).to(tdt))
    assert dx.dtype == tdt and ds.dtype == torch.float32
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    for a, b in ((tout, out), (dx, jdx), (ds, jds)):
        b = np.asarray(b.astype(jnp.float32))
        assert np.abs(np_of(a.float()) - b).max() <= tol * np.abs(b).max()
    # no gradient recorded: the plain path, same numbers
    with torch.no_grad():
        plain = TL.rms_norm(tx, ts)
    assert plain.grad_fn is None and torch.equal(plain, tout.detach())


def test_rmsnorm_keeps_x_in_its_dtype_and_a_float32_rstd():
    """What the forward saves for the backward: x itself (bf16) and the
    (B, S, 1) float32 rstd, not float32 panels of x's size."""
    x = torch.randn(2, 5, 16, dtype=torch.bfloat16, requires_grad=True)
    s = torch.ones(16, requires_grad=True)
    saved = TL.rms_norm(x, s).grad_fn.saved_tensors
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [
        (torch.bfloat16, (2, 5, 16)), (torch.float32, (2, 5, 1)),
        (torch.float32, (16,))]


# ---------------------------------------------------------------------------
# the loss and its gradients, every family
# ---------------------------------------------------------------------------

def _batch(cfg, b=2, s=32, seed=5):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((b, 1), -100, np.int32)], 1)
    lab[0, 3] = -100
    batch = {"tokens": tok, "labels": lab}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(
            size=(b, 16, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: t_of(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _port_loss_and_grads(cfg, tree, batch):
    model = convert.lm_from_numpy(cfg, tree, "cpu")
    params = dict(model.named_parameters())
    total, metrics = TLM.loss_fn(cfg, model, _torch_batch(batch))
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), metrics, convert.grads_to_numpy(dict(zip(params, grads)))


_REFERENCE = {}


def _reference(arch):
    """(weights tree, batch, reference loss, metrics, gradient tree) for
    a smoke configuration; the weights drawn by ``LM.from_config``."""
    if arch not in _REFERENCE:
        cfg = JC.get_config(arch, smoke=True)
        tree = convert.lm_to_numpy(
            LM.from_config(get_config(arch, smoke=True), seed=2, device="cpu"))
        batch = _batch(cfg)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: JLM.loss_fn(cfg, p, b), has_aux=True))
        (loss, metrics), grads = fn(
            jax.tree_util.tree_map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
        _REFERENCE[arch] = (tree, batch, float(loss),
                            {k: float(v) for k, v in metrics.items()},
                            jax.tree_util.tree_map(np.asarray, grads))
    return _REFERENCE[arch]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, remat):
    tree, batch, loss, metrics, grads = _reference(arch)
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    total, tmetrics, tgrads = _port_loss_and_grads(cfg, tree, batch)
    assert total.dtype == torch.float32 and total.dim() == 0
    assert abs(float(total) - loss) <= LOSS_RTOL * abs(loss)
    assert sorted(tmetrics) == sorted(metrics)
    for k, v in metrics.items():
        assert abs(float(tmetrics[k]) - v) <= LOSS_RTOL * max(abs(v), 1.0), k
    assert ("mtp" in metrics) == (arch == "deepseek-v3-671b")
    assert (metrics["moe_aux"] > 0) == cfg.is_moe
    assert_trees_close(tgrads, grads, GRAD_TOL, arch)


def _remat_calls(cfg):
    """Layers wrapped in a checkpoint by one forward: every block, Mamba
    layer, encoder block, shared-block application."""
    if cfg.family == "hybrid":
        return cfg.n_layers + cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_checkpoints_each_layer_only_while_grad_is_on(arch, monkeypatch):
    calls = []
    real = TLM.checkpoint

    def counted(fn, *a, **kw):
        calls.append(kw["use_reentrant"])
        return real(fn, *a, **kw)

    monkeypatch.setattr(TLM, "checkpoint", counted)
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    model = LM.from_config(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg, s=16))
    total, _ = TLM.loss_fn(cfg, model, batch)
    assert calls == [False] * _remat_calls(cfg)
    total.backward()
    calls.clear()
    with torch.no_grad():
        TLM.loss_fn(cfg, model, batch)
    with torch.inference_mode():
        TLM.loss_fn(cfg, model, batch)
    TLM.loss_fn(dataclasses.replace(cfg, remat=False),
                LM.from_config(dataclasses.replace(cfg, remat=False),
                               seed=0, device="cpu"), batch)
    assert calls == []


def test_bf16_tinyllama_loss_and_gradients():
    arch = "tinyllama-1.1b"
    jcfg = dataclasses.replace(JC.get_config(arch, smoke=True),
                               dtype="bfloat16", remat=True)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="bfloat16", remat=True)
    tree = convert.lm_to_numpy(LM.from_config(cfg, seed=3, device="cpu"))
    batch = _batch(jcfg, seed=6)
    jtree = jax.tree_util.tree_map(
        lambda a, p: jnp.asarray(a, p.dtype), tree,
        JLM.init_params(jcfg, jax.random.PRNGKey(0)))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JLM.loss_fn(jcfg, p, b), has_aux=True))(
        jtree, {k: jnp.asarray(v) for k, v in batch.items()})
    total, _, tgrads = _port_loss_and_grads(cfg, tree, batch)
    assert abs(float(total) - float(loss)) <= BF16_TOL * abs(float(loss))
    assert_trees_close(tgrads, jax.tree_util.tree_map(
        lambda g: np.asarray(g.astype(jnp.float32)), grads), BF16_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_KW = dict(lr=1e-3, warmup=2, total_steps=10)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_train_step_matches_reference_over_two_steps(arch):
    jcfg = JC.get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    model = LM.from_config(cfg, seed=1, device="cpu")
    tree = convert.lm_to_numpy(model)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = j_adamw_init(jparams)
    jstep = jax.jit(j_make_train_step(jcfg, **STEP_KW))
    opt = adamw_init(model)
    step = make_train_step(cfg, **STEP_KW)
    for s in range(2):
        b = j_synthetic_batch(0, s, 2, 16, cfg.vocab, np_out=True)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        m = step(model, opt, _torch_batch(b))
        assert sorted(m) == sorted(jm)
        for k in m:
            assert m[k].dim() == 0 and m[k].device.type == "cpu"
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(
                abs(float(jm[k])), 1e-3), (arch, s, k)
    assert int(opt["step"]) == int(jopt["step"]) == 2
    assert opt["step"].dtype == torch.int32
    tol = 1e-5 + 1e-2 * STEP_KW["lr"]
    for path, want in flat(jax.tree_util.tree_map(np.asarray,
                                                  jparams)).items():
        got = flat(convert.lm_to_numpy(model))[path]
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)
    assert_trees_close(convert.opt_to_numpy(opt)["m"],
                       jax.tree_util.tree_map(np.asarray, jopt["m"]), 1e-4)
    assert_trees_close(convert.opt_to_numpy(opt)["v"],
                       jax.tree_util.tree_map(np.asarray, jopt["v"]), 1e-4)


def test_microbatch_accumulation_equivalence():
    """n_micro in {1, 2, 4}: the same parameters after one step within
    the reference's 5e-5; the accumulators float32 for float32 weights."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    b = _torch_batch(synthetic_batch(0, 0, 8, 32, cfg.vocab, np_out=True))
    outs, losses = [], []
    for n_micro in (1, 2, 4):
        model = LM.from_config(cfg, seed=0, device="cpu")
        opt = adamw_init(model)
        m = make_train_step(cfg, lr=1e-3, n_micro=n_micro)(model, opt, b)
        outs.append({n: p.detach().clone() for n, p in
                     model.named_parameters()})
        losses.append(float(m["loss"]))
        assert ("moe_aux" in m) == (n_micro == 1)
    for other in outs[1:]:
        for n, p in outs[0].items():
            assert float((p - other[n]).abs().max()) < 5e-5, n
    assert max(losses) - min(losses) <= 1e-5 * losses[0]


def test_microbatch_accumulates_bf16_weights_in_accum_dtype(monkeypatch):
    """bf16 weights accumulate in `accum_dtype`, float32 ones (the norms)
    in float32, as the reference's ``acc_dtype``."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              dtype="bfloat16")
    seen = {}
    real = TSTEP.adamw_update

    def spy(params, grads, state, lr_fn, **kw):
        seen.update((n, g.dtype) for n, g in grads.items())
        return real(params, grads, state, lr_fn, **kw)

    monkeypatch.setattr(TSTEP, "adamw_update", spy)
    model = LM.from_config(cfg, seed=0, device="cpu")
    b = _torch_batch(synthetic_batch(0, 0, 4, 16, cfg.vocab, np_out=True))
    make_train_step(cfg, n_micro=2, accum_dtype=torch.bfloat16)(
        model, adamw_init(model), b)
    for n, p in model.named_parameters():
        assert seen[n] == (torch.bfloat16 if p.dtype == torch.bfloat16
                           else torch.float32), n


def test_loss_decreases_over_training():
    """The reference's bar: a fixed batch, 25 steps at lr 1e-3, the last
    loss below 0.7 of the first."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = LM.from_config(cfg, seed=0, device="cpu")
    opt = adamw_init(model)
    step = make_train_step(cfg, lr=1e-3, warmup=2, total_steps=40)
    b = synthetic_batch(0, 0, 4, 32, cfg.vocab, device="cpu")
    losses = [float(step(model, opt, b)["loss"]) for _ in range(25)]
    assert losses[-1] < 0.7 * losses[0], losses


#: calls that read a device value on the host
SYNCING_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNCING_BUILTINS = {"float", "int", "bool"}


@pytest.mark.parametrize("module", [TSTEP, TADAMW, TCOMP])
def test_train_step_code_makes_no_host_sync(module):
    """The step's, the optimizer's and the compression's code reads no
    device value on the host: no ``.item()`` / ``.tolist()`` / ``.cpu()``
    / ``.numpy()``, no ``float()`` / ``int()`` / ``bool()``."""
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if isinstance(node, ast.Call):
            f = node.func
            assert not (isinstance(f, ast.Attribute)
                        and f.attr in SYNCING_METHODS), (module, f.attr)
            assert not (isinstance(f, ast.Name)
                        and f.id in SYNCING_BUILTINS), (module, f.id)


def test_eval_step_runs_under_inference_mode():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    model = LM.from_config(cfg, seed=0, device="cpu")
    b = _torch_batch(_batch(cfg))
    m = make_eval_step(cfg)(model, b)
    assert sorted(m) == ["ce", "loss", "moe_aux", "mtp"]
    assert all(v.is_inference() for v in m.values())
    total, _ = TLM.loss_fn(cfg, model, b)
    assert float(m["loss"]) == float(total)
