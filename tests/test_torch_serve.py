"""PyTorch port vs the JAX package: the LM serving path, attention and the
dense family.

* ``gqa_decode`` across the ring's wrap, with and without a window;
  ``mla_decode`` with an index past the cache's length (the reference's
  clamped write); ``cross_attn_forward``;
* the four dense smoke LMs with the reference's weights
  (``convert.lm_from_numpy``): ``prefill`` logits and every cache leaf
  against ``repro.models.serve.prefill``, each ``decode_step``'s logits
  and leaves against the reference's step after every step, and one
  step from a reference cache taken mid-sequence
  (``convert.cache_from_numpy``);
* the reference's own serving checks, repeated in the port (the ring
  cache against full-window attention, MLA's latent cache shapes,
  deterministic generation);
* ``launch.serve.generate`` against the reference's greedy loop (the
  same tokens), and ``launch.serve.main`` on the CPU.

Tolerances, float32: logits and outputs within 1e-5 of max |value|, cache
leaves within 1e-5 of max(1, max |leaf|): the same float32 sums taken in
other orders (measured 2e-7 to 2e-6); the index exactly. The reference's
own test holds decode to its forward at 2e-3 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import np_of, one_torch_thread  # noqa: F401 (fixture)
from repro import configs as JC
from repro.models import attention as JA
from repro.models import lm as JLM
from repro.models import serve as JS
from repro_torch import convert, get_config
from repro_torch.launch import serve as TLS
from repro_torch.models import attention as TA
from repro_torch.models import serve as TS

DENSE = ["tinyllama-1.1b", "phi3-mini-3.8b", "starcoder2-7b", "chatglm3-6b"]
TOL = 1e-5
B, S = 2, 24


def t_of(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = np_of(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, (gap, scale)


def close_rel(got, want, tol=TOL):
    """max |got - want| <= tol * max |want| (logits, outputs)."""
    got, want = np_of(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def same_cache(got: dict, want: dict):
    """Every leaf of a port cache against a reference cache."""
    got = convert.cache_to_numpy(got)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        a = np.asarray(a)
        if name == "index":
            assert got[name].dtype == np.int32 and int(got[name]) == int(a)
        else:
            close(got[name], a.astype(np.float32))


# ---------------------------------------------------------------------------
# the serving path of one smoke configuration against the reference
# ---------------------------------------------------------------------------

def reference_serving(arch, mid=13, seed=0, **over):
    """The reference's weights, tokens and serving results for `arch`'s
    smoke configuration: its prefill (the scan) and, from its jitted
    decode step, the cache after every step. Returns a dict."""
    cfg = dataclasses.replace(JC.get_config(arch, smoke=True), **over)
    # jitted: the same initialisers, compiled once
    p = jax.jit(JLM.init_params, static_argnums=0)(cfg,
                                                  jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 7)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    src = None
    cache = JS.init_cache(cfg, B, S, dtype=jnp.float32)
    if cfg.family == "encdec":
        src = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
        cache = JS.prefill_encoder(cfg, p, cache, jnp.asarray(src))
    first = jax.tree_util.tree_map(np.asarray, cache)
    end, logits = JS.prefill(cfg, p, cache, jnp.asarray(tok))
    step = jax.jit(lambda c, t: JS.decode_step(cfg, p, c, t))
    steps = []
    for i in range(S):
        lg, cache = step(cache, jnp.asarray(tok[:, i:i + 1]))
        steps.append((np.asarray(lg), jax.tree_util.tree_map(np.asarray,
                                                             cache)))
    return dict(over=over, mid=mid, tok=tok, src=src, first=first,
                params=jax.tree_util.tree_map(np.asarray, p),
                end=jax.tree_util.tree_map(np.asarray, end),
                logits=np.asarray(logits), steps=steps)


def port_model(arch, ref):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **ref["over"])
    return cfg, convert.lm_from_numpy(cfg, ref["params"], device="cpu")


def port_cache(cfg, model, ref):
    cache = TS.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    if ref["src"] is not None:
        cache = TS.prefill_encoder(model, cache, t_of(ref["src"]))
    return cache


def check_serving(arch, ref):
    """The port's prefill, every step and a step from the reference's
    mid-sequence cache against the reference."""
    cfg, model = port_model(arch, ref)
    tok = t_of(ref["tok"]).long()
    with torch.inference_mode():
        cache = port_cache(cfg, model, ref)
        same_cache(cache, ref["first"])
        cache, logits = TS.prefill(model, cache, tok)
        close_rel(logits, ref["logits"])
        same_cache(cache, ref["end"])

        # every step, leaf for leaf (the port writes the cache in place)
        cache = port_cache(cfg, model, ref)
        for i, (lg, leaves) in enumerate(ref["steps"]):
            got, back = TS.decode_step(model, cache, tok[:, i:i + 1])
            assert back is cache
            close_rel(got, lg)
            same_cache(cache, leaves)

        # one step from the reference's cache taken mid-sequence
        m = ref["mid"]
        cache = convert.cache_from_numpy(ref["steps"][m - 1][1], "cpu")
        got, cache = TS.decode_step(model, cache, tok[:, m:m + 1])
        close_rel(got, ref["steps"][m][0])
        same_cache(cache, ref["steps"][m][1])


@pytest.fixture(scope="module", params=DENSE)
def dense_ref(request):
    return request.param, reference_serving(request.param)


def test_dense_serving_matches_reference(dense_ref):
    check_serving(*dense_ref)


# ---------------------------------------------------------------------------
# the decode steps of attention, alone
# ---------------------------------------------------------------------------

def _attn_params(cfg, rng, mla=False, cross=False):
    if mla:
        jp = JA.init_attn(cfg, jax.random.PRNGKey(3), jnp.float32)
        mod = TA.MLAAttention(cfg, "cpu", torch.float32)
    else:
        init = JA.init_cross_attn if cross else JA.init_attn
        jp = init(cfg, jax.random.PRNGKey(3), jnp.float32)
        mod = TA.Attention(cfg, "cpu", torch.float32,
                           n_kv=cfg.n_heads if cross else None)
    with torch.no_grad():
        for name, a in jp.items():
            getattr(mod, name).copy_(t_of(np.asarray(a)))
    return jp, mod


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("index", [0, 3, 8, 11, 29])
def test_gqa_decode_across_the_ring(window, index):
    """W = 8 slots: index 8 writes slot 0 again, 11 slot 3, 29 slot 5;
    the slots hold keys of earlier positions (random here), masked by
    their absolute positions and the window."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              window=window)
    rng = np.random.default_rng(index + window)
    jp, mod = _attn_params(cfg, rng)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, cfg.n_kv_heads, 8, cfg.dh)).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    want = JA.gqa_decode(cfg, jp, jnp.asarray(x), jnp.asarray(ck),
                         jnp.asarray(cv), jnp.int32(index))
    tk, tv = t_of(ck.copy()), t_of(cv.copy())
    got = TA.gqa_decode(cfg, mod, t_of(x), tk, tv,
                        torch.tensor(index, dtype=torch.int32))
    assert got[1] is tk and got[2] is tv
    close_rel(got[0], want[0])
    close(tk, want[1])
    close(tv, want[2])
    written = np.flatnonzero(np.abs(np_of(tk) - ck).sum((0, 1, 3)))
    assert written.tolist() == [index % 8]


@pytest.mark.parametrize("index", [0, 5, 15, 16, 19])
def test_mla_decode_clamps_past_the_cache(index):
    """A latent cache of 16 rows: at index >= 16 the reference's
    dynamic_update_slice clamps its start and overwrites row 15, and
    every row is visible; the port does the same."""
    cfg = get_config("deepseek-v3-671b", smoke=True)
    rng = np.random.default_rng(index)
    jp, mod = _attn_params(cfg, rng, mla=True)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(2, 16, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(2, 16, cfg.qk_rope_dim)).astype(np.float32)
    want = JA.mla_decode(cfg, jp, jnp.asarray(x), jnp.asarray(ckv),
                         jnp.asarray(kr), jnp.int32(index))
    tc, tr = t_of(ckv.copy()), t_of(kr.copy())
    got = TA.mla_decode(cfg, mod, t_of(x), tc, tr,
                        torch.tensor(index, dtype=torch.int32))
    close_rel(got[0], want[0])
    close(tc, want[1])
    close(tr, want[2])
    written = np.flatnonzero(np.abs(np_of(tc) - ckv).sum((0, 2)))
    assert written.tolist() == [min(index, 15)]


@pytest.mark.parametrize("se", [7, 16])
def test_cross_attn_forward(se):
    cfg = get_config("seamless-m4t-medium", smoke=True)
    rng = np.random.default_rng(se)
    jp, mod = _attn_params(cfg, rng, cross=True)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, se, cfg.d_model)).astype(np.float32)
    want = JA.cross_attn_forward(cfg, jp, jnp.asarray(x), jnp.asarray(enc))
    close_rel(TA.cross_attn_forward(cfg, mod, t_of(x), t_of(enc)), want)
    flash = dataclasses.replace(cfg, attn_impl="flash")
    close_rel(TA.cross_attn_forward(flash, mod, t_of(x), t_of(enc)), want)


def test_flash_refuses_mla_widths():
    """MLA's q / k (qk_nope + qk_rope) and v (v_head) widths differ; the
    kernel takes one width, so attn_impl="flash" raises naming both (the
    reference's Pallas route fails there too, in dot_general)."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              attn_impl="flash")
    rng = np.random.default_rng(0)
    _, mod = _attn_params(cfg, rng, mla=True)
    x = t_of(rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32))
    with pytest.raises(ValueError, match="q / k 24 and v 16"):
        TA.mla_forward(cfg, mod, x, torch.arange(6))


# ---------------------------------------------------------------------------
# the reference's own serving checks, in the port
# ---------------------------------------------------------------------------

def test_ring_cache_equals_full_window_attention():
    """SWA ring cache (W == window) reproduces full-buffer decoding."""
    from repro_torch import LM
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              window=8)
    model = LM.from_config(cfg, seed=0, device="cpu")
    tok = torch.randint(0, cfg.vocab, (1, 24),
                        generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, full = TS.prefill(model, TS.init_cache(cfg, 1, 24, torch.float32,
                                                  device="cpu"), tok)
        ring = TS.init_cache(cfg, 1, cfg.window, torch.float32, device="cpu")
        assert ring["k"].shape[3] == 8
        _, dec = TS.prefill(model, ring, tok)
    assert float((full - dec).abs().max()) < 1e-4


def test_mla_latent_cache_shapes():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    cache = TS.init_cache(cfg, 2, 16, device="cpu")
    assert cache["ckv"].shape == (cfg.n_layers, 2, 16, cfg.kv_lora_rank)
    assert cache["kr"].shape == (cfg.n_layers, 2, 16, cfg.qk_rope_dim)
    assert cache["ckv"].dtype == torch.bfloat16
    assert cache["index"].shape == () and cache["index"].dtype == torch.int32
    kv_full = cfg.n_layers * 2 * 16 * cfg.n_heads * (cfg.qk_nope_dim
                                                     + cfg.v_head_dim)
    assert (cache["ckv"].numel() + cache["kr"].numel()) * 4 < kv_full


def test_generation_deterministic():
    from repro_torch import LM
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = LM.from_config(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (1, 8),
                            generator=torch.Generator().manual_seed(0))
    runs = []
    with torch.inference_mode():
        for _ in range(2):
            cache = TS.init_cache(cfg, 1, 20, torch.float32, device="cpu")
            runs.append(TLS.generate(model, cache, prompts, 7).tokens)
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (1, 7)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x22b"])
def test_generate_matches_the_reference_loop(arch):
    """The reference's greedy loop (launch/serve.py: prefill, argmax,
    then decode steps feeding back their argmax) and ``generate`` on the
    same weights and prompts give the same tokens."""
    cfg = JC.get_config(arch, smoke=True)
    p = JLM.init_params(cfg, jax.random.PRNGKey(1))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9))
    gen = 6
    cache = JS.init_cache(cfg, 2, 9 + gen, dtype=jnp.float32)
    cache, logits = JS.prefill(cfg, p, cache, jnp.asarray(prompts))
    decode = jax.jit(lambda c, t: JS.decode_step(cfg, p, c, t))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for _ in range(gen - 1):
        lg, cache = decode(cache, tok)
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    tcfg = get_config(arch, smoke=True)
    model = convert.lm_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, p), device="cpu")
    with torch.inference_mode():
        out = TLS.generate(model, TS.init_cache(tcfg, 2, 9 + gen,
                                                torch.float32, device="cpu"),
                           t_of(prompts), gen)
    assert out.tokens.shape == (2, gen)
    np.testing.assert_array_equal(np_of(out.tokens), want)
    assert int(out.cache["index"]) == 9 + gen - 1
    assert out.prefill_s > 0 and out.decode_s > 0


def test_main_on_the_cpu(capsys):
    out = TLS.main(["--arch", "seamless-m4t-medium", "--smoke", "--batch",
                    "2", "--prompt-len", "5", "--gen", "4", "--device",
                    "cpu"])
    assert out.shape == (2, 4) and out.dtype == np.int64
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "generated shape: (2, 4)"
    assert lines[1].startswith("prefill: ") and "ms/token  (2 seqs)" in lines[1]
    again = TLS.main(["--arch", "seamless-m4t-medium", "--smoke", "--batch",
                      "2", "--prompt-len", "5", "--gen", "4", "--device",
                      "cpu"])
    np.testing.assert_array_equal(out, again)
