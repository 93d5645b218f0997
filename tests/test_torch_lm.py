"""PyTorch port vs the JAX package: the LM substrate's forward.

* the ten configurations (``repro_torch.configs``) equal the reference's
  field for field, smoke and full, with equal parameter counts;
* each layer of ``repro_torch.models.layers`` against
  ``repro.models.layers`` on the same seeded inputs: RMSNorm and LayerNorm
  (float32, eps 1e-6, population variance), interleaved RoPE at
  rotary_pct 1.0 and 0.5, the SwiGLU and GELU-tanh MLPs and tied logits;
* the four dense smoke models with the reference's own weights
  (``convert.lm_from_numpy``) against ``repro.models.lm.forward``, with
  ``attn_impl`` "xla" and "flash" (the Pallas kernel in interpret mode on
  the JAX side, the kernel's twin on the port's), at S = 100 and 256;
* the six other families' smoke models against the reference's forward
  (MoE, MLA with first_k_dense layers and the MTP module carried, Mamba2,
  the hybrid's shared block, encoder-decoder, VLM patch rows).

Tolerances: float32 logits within 1e-5 of max |logit| (two layers of
float32 sums taken in other orders: about 3e-7 is typical); one bfloat16
forward within 2e-2 of max |logit| with top-1 agreement, since bf16
rounds every product and activation, in other places in each framework
(about 5e-3 is typical, the last rounding of the logits alone 2^-8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import np_of, one_torch_thread  # noqa: F401 (fixture)
from repro import configs as JC
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import LM, ModelConfig, convert, get_config
from repro_torch import configs as TC
from repro_torch.models import layers as TL

DENSE = ["tinyllama-1.1b", "phi3-mini-3.8b", "starcoder2-7b", "chatglm3-6b"]
OTHER = ["mixtral-8x22b", "deepseek-v3-671b", "mamba2-780m", "zamba2-7b",
         "seamless-m4t-medium", "llava-next-mistral-7b"]
F32_TOL = 1e-5
BF16_TOL = 2e-2


def t_of(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert TC.ARCHS == JC.ARCHS and TC.all_archs() == JC.all_archs()
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_config_equals_reference(arch):
    for smoke in (True, False):
        t, j = get_config(arch, smoke=smoke), JC.get_config(arch, smoke=smoke)
        assert isinstance(t, ModelConfig)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("dh", "is_moe", "sub_quadratic", "param_count",
                     "active_param_count"):
            assert _prop(t, prop) == _prop(j, prop), (arch, smoke, prop)


def _prop(cfg, name):
    """A property's value, or the name of the error it raises (``dh`` of
    the attention-free mamba2 divides by n_heads = 0 in both packages)."""
    try:
        return getattr(cfg, name)
    except ArithmeticError as e:
        return type(e).__name__


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 48)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    want = np.asarray(JL.apply_norm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x), "rmsnorm"))
    got = np_of(TL.apply_norm(t_of(x), t_of(scale), kind="rmsnorm"))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_layernorm_population_variance_and_eps():
    """A narrow row (d = 6) of small spread: the unbiased variance would
    be 6/5 too large and eps = 1e-5 ten times too large, both far beyond
    the tolerance."""
    rng = np.random.default_rng(1)
    x = (0.01 + 3e-3 * rng.normal(size=(4, 7, 6))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    want = np.asarray(JL.apply_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), "layernorm"))
    got = np_of(TL.apply_norm(t_of(x), t_of(scale), t_of(bias),
                              kind="layernorm"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    torch_default = np_of(torch.nn.functional.layer_norm(
        t_of(x), (6,), t_of(scale), t_of(bias)))
    assert np.abs(torch_default - want).max() > 1e-2
    unbiased = ((x - x.mean(-1, keepdims=True))
                / np.sqrt(x.var(-1, ddof=1, keepdims=True) + 1e-6)
                * scale + bias)
    assert np.abs(unbiased - want).max() > 1e-2


@pytest.mark.parametrize("rotary_pct,dh", [(1.0, 16), (1.0, 64), (0.5, 16),
                                           (0.5, 128)])
def test_rope_interleaved(rotary_pct, dh):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 300, dh)).astype(np.float32)
    pos = np.arange(300)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                    rotary_pct))
    got = np_of(TL.apply_rope(t_of(x), t_of(pos), 1e4, rotary_pct))
    # float32 angles up to 300 rad: cos/sin of either library within a
    # few ulps of the angle
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    keep = int(dh * rotary_pct)
    assert np.array_equal(got[..., keep:], x[..., keep:])
    if rotary_pct == 1.0:    # not the rotate-half convention
        ang = pos[:, None] / 1e4 ** (np.arange(0, dh, 2) / dh)
        cos, sin = np.tile(np.cos(ang), 2), np.tile(np.sin(ang), 2)
        half = np.concatenate([-x[..., dh // 2:], x[..., :dh // 2]], -1)
        assert np.abs(x * cos + half * sin - want).max() > 0.1


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    p = {k: (rng.normal(size=s) * 0.3).astype(np.float32)
         for k, s in (("wg", (32, 80)), ("wu", (32, 80)), ("wd", (80, 32)))}
    if kind == "gelu":
        del p["wg"]
    want = np.asarray(JL.apply_mlp({k: jnp.asarray(a) for k, a in p.items()},
                                   jnp.asarray(x), kind))
    got = np_of(TL.apply_mlp(t_of(x), t_of(p["wu"]), t_of(p["wd"]),
                             t_of(p["wg"]) if "wg" in p else None, kind))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind == "gelu":   # the tanh approximation, not erf
        h = x @ p["wu"]
        erf = np_of(torch.nn.functional.gelu(t_of(h))) @ p["wd"]
        assert np.abs(erf - want).max() > 1e-4


def test_embedding_and_tied_logits():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, (3, 7))
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        np_of(TL.embed_tokens(t_of(table), t_of(tok))),
        np.asarray(JL.embed_tokens({"table": jnp.asarray(table)},
                                   jnp.asarray(tok))))
    want = np.asarray(JL.logits_out({"table": jnp.asarray(table)},
                                    jnp.asarray(x)))
    got = np_of(TL.logits_out(t_of(table), t_of(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_trunc_normal_initialiser():
    gen = torch.Generator().manual_seed(0)
    w = TL.trunc_normal(gen, (256, 512), 0.5, torch.float32)
    again = TL.trunc_normal(torch.Generator().manual_seed(0), (256, 512), 0.5,
                            torch.float32)
    assert torch.equal(w, again)
    assert float(w.abs().max()) <= 1.0
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / 0.5 - 0.8796) < 0.01
    assert TL.trunc_normal(gen, (4,), 1.0, torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def _reference(cfg, s, seed=0, dtype=None):
    """(params as numpy, tokens, reference logits as float32 numpy)."""
    p = JLM.init_params(cfg, jax.random.PRNGKey(seed))
    tok = np.random.default_rng(seed + s).integers(0, cfg.vocab, (2, s))
    logits, aux = JLM.forward(cfg, p, jnp.asarray(tok))
    assert float(aux) == 0.0
    return (jax.tree_util.tree_map(np.asarray, p), tok,
            np.asarray(logits.astype(jnp.float32)))


def _port(arch, params, tok, **kw):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    model = convert.lm_from_numpy(cfg, params, device="cpu")
    with torch.inference_mode():
        logits, aux = model(t_of(tok))
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    return logits


@pytest.mark.parametrize("s", [100, 256])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_forward_matches_reference(arch, attn_impl, s):
    cfg = dataclasses.replace(JC.get_config(arch, smoke=True),
                              attn_impl=attn_impl)
    params, tok, want = _reference(cfg, s)
    got = _port(arch, params, tok, attn_impl=attn_impl)
    assert got.shape == (2, s, cfg.vocab) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(np_of(got) - want).max() <= F32_TOL * scale


def test_bf16_smoke_forward():
    cfg = dataclasses.replace(JC.get_config("tinyllama-1.1b", smoke=True),
                              attn_impl="flash", dtype="bfloat16")
    params, tok, want = _reference(cfg, 100, seed=1)
    got = _port("tinyllama-1.1b", params, tok, attn_impl="flash",
                dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    got = np_of(got.float())
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_from_config_seeds_the_weights():
    cfg = get_config("starcoder2-7b", smoke=True)
    a = LM.from_config(cfg, seed=3, device="cpu")
    b = LM.from_config(cfg, seed=3, device="cpu")
    c = LM.from_config(cfg, seed=4, device="cpu")
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(x, y), name
        if x.dim() == 2:
            assert not torch.equal(x, z), name
            bound = 2 * (1.0 if name == "embed.table" else x.shape[0] ** -0.5)
            assert float(x.detach().abs().max()) <= bound, name
    blk = a.layers[0]
    assert torch.equal(blk.ln1.scale, torch.ones(cfg.d_model))
    assert torch.equal(blk.ln1.bias, torch.zeros(cfg.d_model))
    assert not hasattr(blk.mlp, "wg")                   # gelu MLP
    with torch.inference_mode():
        logits, _ = a(torch.zeros((1, 5), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())


def reference_tree(model):
    """A port LM's weights as the reference's parameter tree (numpy): the
    blocks of ``layers`` / ``dense_layers`` / ``enc_layers`` stacked along
    a leading layer axis, every other leaf at its path."""
    tree, stacked = {}, {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "dense_layers", "enc_layers"):
            stacked.setdefault((parts[0],) + tuple(parts[2:]), []).append(
                p.detach().numpy())
        else:
            stacked[tuple(parts)] = p.detach().numpy()
    for path, a in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(a) if isinstance(a, list) else a
    return tree


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_forward_matches_reference(arch):
    """The six families after the dense one: the logits and the MoE loss
    against ``repro.models.lm.forward`` on the same weights (drawn by
    ``LM.from_config``, handed to the reference as its parameter tree and
    back through ``lm_from_numpy``, leaf for leaf), with the vlm family's
    patch embeddings and the encdec family's frame embeddings.
    ``tests/test_torch_serve_families.py`` runs the reference's own
    ``init_params`` trees through ``lm_from_numpy``."""
    cfg = JC.get_config(arch, smoke=True)
    model = LM.from_config(get_config(arch, smoke=True), seed=2, device="cpu")
    tree = reference_tree(model)
    back = convert.lm_from_numpy(model.cfg, tree, device="cpu")
    for (name, a), b in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab, (2, 32))
    extra, textra = {}, {}
    if cfg.family == "vlm":
        a = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        extra["patch_embeds"], textra["patch_embeds"] = jnp.asarray(a), t_of(a)
    if cfg.family == "encdec":
        a = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
        extra["src_embeds"], textra["src_embeds"] = jnp.asarray(a), t_of(a)
    want, aux = JLM.forward(
        cfg, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tok),
        **extra)
    with torch.inference_mode():
        got, taux = model(t_of(tok), **textra)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 32, cfg.vocab)
    assert np.abs(np_of(got) - want).max() <= F32_TOL * np.abs(want).max()
    assert taux.dtype == torch.float32
    assert abs(float(taux) - float(aux)) <= 1e-5 * max(1.0, abs(float(aux)))
    assert (float(aux) > 0) == cfg.is_moe


def test_lm_from_numpy_refuses_a_missing_or_misshaped_leaf():
    cfg = JC.get_config("tinyllama-1.1b", smoke=True)
    params = jax.tree_util.tree_map(
        np.asarray, JLM.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = get_config("tinyllama-1.1b", smoke=True)
    del params["layers"]["mlp"]["wu"]
    with pytest.raises(KeyError, match="layers/mlp/wu"):
        convert.lm_from_numpy(tcfg, params, device="cpu")
    params = jax.tree_util.tree_map(
        np.asarray, JLM.init_params(cfg, jax.random.PRNGKey(0)))
    params["layers"]["attn"]["wk"] = params["layers"]["attn"]["wk"][:1]
    with pytest.raises(ValueError, match="layers/attn/wk"):
        convert.lm_from_numpy(tcfg, params, device="cpu")
    params["layers"]["attn"]["wk"] = np.zeros((2, 64, 16), np.float32)
    with pytest.raises(ValueError, match="layers/attn/wk"):
        convert.lm_from_numpy(tcfg, params, device="cpu")
