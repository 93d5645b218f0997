"""PyTorch port vs the JAX package: the optimizer and the gradient
compression (``repro_torch.optim``), and ``train.step``'s compressed
reduction over a gloo world.

* ``adamw_update`` and ``clip_by_global_norm`` fed the same numpy
  gradients as ``repro.optim``'s, over three steps, with float32 and
  bfloat16 parameters and float32 and bfloat16 moments;
* ``cosine_schedule`` at every step of a schedule;
* ``compress_int8`` / ``error_feedback_compress``: the int8 values, the
  scale and the error bit for bit against the reference (both round half
  to even), the EF invariant, the 4x ratio, the quantization bound;
* ``make_train_step(grad_compression=True, pod_group=...)`` in a 2-rank
  gloo world against the reference's EF functions applied to each rank's
  gradients, then the reference's AdamW.

Tolerances: float32 parameters and moments within 4e-6 of each leaf's
max |x|. The update is elementwise float32 arithmetic (the frameworks may
fuse a multiply and an add where the other rounds twice), but the global
norm sums every leaf's squares in float32 in other orders (the port's
within 1e-6 of float64, ``test_global_norm_sums_accurately``; the
reference's XLA sum in its own order), and v carries the square of the clipping scale over two
clipped steps. bfloat16
parameters and moments within one bf16 step (at most 2^-7 of the
leaf's max: 8 significant bits),
since a float32 difference of an ulp may round to the neighbouring bf16
value. The schedule within 2e-7 relative, or 1e-6 of the base rate where
the cosine nears zero (1 + cos cancels, an ulp of cos becomes 2e-5 of
the value). The gloo world's numbers are bit for bit: the parent repeats
the ranks' steps with the reference's EF functions and the port's AdamW.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_parity import (assert_trees_close, one_torch_thread,  # noqa: F401
                               run_world, world_results, flat_tree as flat)
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import compress_int8 as j_compress
from repro.optim import cosine_schedule as j_cosine
from repro.optim import decompress_int8 as j_decompress
from repro.optim import error_feedback_compress as j_ef
from repro_torch import LM, convert, get_config
from repro_torch.data import synthetic_batch
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_int8, cosine_schedule,
                               decompress_int8, error_feedback_compress,
                               leaf_order)

TOL = 4e-6


def t_of(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grads_like(model, rng, scale):
    return {n: (rng.normal(size=tuple(p.shape)) * scale).astype(np.float32)
            for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(dtype, moments):
    """Three steps on the same gradients (the first two clipped, the third
    under max_norm), the TinyLlama smoke tree."""
    import dataclasses
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              dtype=dtype)
    model = LM.from_config(cfg, seed=0, device="cpu")
    jdt = jnp.dtype(dtype)
    jparams = {}
    for path, a in flat(convert.lm_to_numpy(model)).items():
        node = jparams
        for k in path[:-1]:
            node = node.setdefault(k, {})
        # the reference's dtypes: norms float32, the rest the model's
        node[path[-1]] = jnp.asarray(a, jnp.float32 if path[-1] in (
            "scale", "bias") else jdt)
    mdt = getattr(torch, moments)
    jstate = j_adamw_init(jparams, jnp.dtype(moments))
    state = adamw_init(model, dtype=mdt)
    j_lr, t_lr = j_cosine(1e-3, 2, 10), cosine_schedule(1e-3, 2, 10)
    rng = np.random.default_rng(3)
    for s, scale in enumerate((1.0, 0.3, 1e-4)):
        g = _grads_like(model, rng, scale)
        named = dict(model.named_parameters())
        tg = {n: t_of(a).to(named[n].dtype) for n, a in g.items()}
        jg = jax.tree_util.tree_map(
            lambda a, p: jnp.asarray(a, p.dtype),
            convert.grads_to_numpy({n: t.float() for n, t in tg.items()}),
            jparams)
        jparams, jstate, jm = j_adamw_update(jparams, jg, jstate, j_lr)
        m = adamw_update(model, tg, state, t_lr)
        assert state["step"].dtype == torch.int32
        assert int(state["step"]) == int(jstate["step"]) == s + 1
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * float(jm["grad_norm"])
        assert float(m["lr"]) == float(jm["lr"])
    for n, p in model.named_parameters():
        assert p.dtype == (torch.float32 if n.endswith(("scale", "bias"))
                           else getattr(torch, dtype))
        assert state["m"][n].dtype == state["v"][n].dtype == mdt
    ptol = TOL if dtype == "float32" else 2 ** -7
    assert_trees_close(convert.lm_to_numpy(model),
                       jax.tree_util.tree_map(np.asarray, jparams), ptol)
    mtol = TOL if moments == "float32" else 2 ** -7
    ours = convert.opt_to_numpy(state)
    for key in ("m", "v"):
        assert_trees_close(ours[key], jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jstate[key]), mtol, key)


def test_adamw_update_in_chunks(monkeypatch):
    """Chunks of a few leaves give the numbers of one chunk."""
    cfg = get_config("starcoder2-7b", smoke=True)
    g = _grads_like(LM.from_config(cfg, seed=0, device="cpu"),
                    np.random.default_rng(4), 0.5)
    out = []
    for chunk in (1 << 27, 1000):
        monkeypatch.setattr("repro_torch.optim.adamw.CHUNK_ELEMS", chunk)
        model = LM.from_config(cfg, seed=0, device="cpu")
        state = adamw_init(model)
        for _ in range(2):
            adamw_update(model, {n: t_of(a) for n, a in g.items()}, state,
                         cosine_schedule(1e-3, 1, 10))
        out.append(convert.lm_to_numpy(model))
    assert_trees_close(out[1], out[0], 0.0)


def test_clip_by_global_norm_matches_reference():
    g = {"a": np.full((10,), 3.0, np.float32),
         "b": np.full((10,), 4.0, np.float32)}
    clipped, gn = clip_by_global_norm({k: t_of(v) for k, v in g.items()}, 1.0)
    jclipped, jgn = j_clip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    assert abs(float(gn) - np.sqrt(250.0)) < 1e-4
    assert float(gn) == float(jgn)
    for k in g:
        np.testing.assert_array_equal(clipped[k].numpy(),
                                      np.asarray(jclipped[k]))
    # under the norm: unchanged, in each leaf's own dtype
    small = {"x": torch.full((3,), 0.1, dtype=torch.bfloat16),
             "y": torch.full((2,), 0.2)}
    out, n = clip_by_global_norm(small, 1.0)
    assert out["x"].dtype == torch.bfloat16 and torch.equal(out["x"],
                                                            small["x"])
    assert torch.equal(out["y"], small["y"]) and float(n) < 1.0


def test_global_norm_sums_accurately():
    """The norm of a 2^22-element leaf within 1e-6 of the float64 value
    (4e-8 measured); the CPU's float32 ``vector_norm`` / ``_foreach_norm``,
    which accumulate one element after another, are 9e-5 off here, which
    is why the sums of squares go through ``sum``."""
    rng = np.random.default_rng(0)
    x = t_of((rng.normal(size=1 << 22) * 0.01).astype(np.float32))
    exact = float(np.sqrt((x.double() ** 2).sum()))
    _, gn = clip_by_global_norm({"a": x}, 1.0)
    assert abs(float(gn) - exact) <= 1e-6 * exact
    naive = float(torch._foreach_norm([x], 2)[0])
    assert abs(naive - exact) > 1e-5 * exact


def test_leaf_order_is_the_reference_tree_order():
    """Sorted parameter names give ``jax.tree_util.tree_leaves``'s order
    of the reference's tree, each stacked leaf's layers in order (layer
    10 after layer 9)."""
    import dataclasses
    cfg = get_config("deepseek-v3-671b", smoke=True)
    model = LM(dataclasses.replace(cfg, n_layers=12), device="meta")
    names = sorted((n for n, _ in model.named_parameters()), key=leaf_order)
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(_ref_tree(model))]
    seen = []
    for n in names:
        p = tuple(x for x in n.split(".") if not x.isdigit())
        if not seen or seen[-1] != p:
            seen.append(p)
    assert seen == paths
    layers = [int(n.split(".")[1]) for n in names
              if n.startswith("layers.") and n.endswith("attn.wo")]
    assert layers == sorted(layers) and len(layers) == 12 - cfg.first_k_dense


def _ref_tree(model):
    """The reference's tree shape of a model (leaves 0)."""
    tree = {}
    for n, _ in model.named_parameters():
        node = tree
        parts = [x for x in n.split(".") if not x.isdigit()]
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = 0
    return tree


def test_cosine_schedule_matches_reference():
    for base, warm, total in ((1e-3, 10, 100), (3e-4, 100, 10000),
                              (1e-3, 0, 5), (2e-4, 7, 7)):
        ours, ref = cosine_schedule(base, warm, total), j_cosine(base, warm,
                                                                 total)
        steps = np.arange(0, total + 12, dtype=np.int32)
        got = np.array([float(ours(torch.tensor(s))) for s in steps])
        want = np.array([float(ref(jnp.int32(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-6 * base)
        assert ours(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(lr(torch.tensor(100))) < 1e-5


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@given(st.integers(0, 1000))
@settings(max_examples=25, deadline=None)
def test_error_feedback_matches_reference_bit_for_bit(seed):
    """q, scale and the new error equal the reference's, and
    decompress(q) + err' == g + err."""
    r = np.random.default_rng(seed)
    g = r.normal(0, r.uniform(0.01, 10), 64).astype(np.float32)
    err = r.normal(0, 0.1, 64).astype(np.float32)
    q, scale, new_err = error_feedback_compress(t_of(g), t_of(err))
    jq, jscale, jerr = j_ef(jnp.asarray(g), jnp.asarray(err))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
    recon = decompress_int8(q, scale) + new_err
    assert np.allclose(recon.numpy(), g + err, atol=1e-6)


def test_round_half_to_even_as_the_reference():
    """Values at exact halves of the scale: both round to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    q, s = compress_int8(t_of(x))
    jq, js = j_compress(jnp.asarray(x))
    assert float(s) == float(js) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 126]


def test_compression_ratio_and_bound():
    g = np.random.default_rng(0).normal(0, 1, 1000).astype(np.float32)
    q, scale = compress_int8(t_of(g))
    jq, jscale = j_compress(jnp.asarray(g))
    assert q.numel() * q.element_size() * 4 == g.nbytes == jq.nbytes * 4
    err = np.abs(decompress_int8(q, scale).numpy() - g)
    assert err.max() <= float(scale) * 0.5 + 1e-7
    np.testing.assert_array_equal(
        decompress_int8(q, scale).numpy(), np.asarray(j_decompress(jq,
                                                                   jscale)))


def test_ef_compression_accumulates_small_signals():
    tiny = torch.full((8,), 1e-4)
    err = torch.zeros(8)
    total = torch.zeros(8)
    for _ in range(50):
        q, s, err = error_feedback_compress(tiny, err)
        total = total + decompress_int8(q, s)
    assert np.allclose(total.numpy() / 50, 1e-4, rtol=0.2)


RANK_TRAIN = """
from repro_torch import LM, convert, get_config
from repro_torch.data import synthetic_batch
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step
cfg = get_config("tinyllama-1.1b", smoke=True)
model = LM.from_config(cfg, seed=0, device="cpu")
opt = adamw_init(model)
step = make_train_step(cfg, lr=1e-3, warmup=1, total_steps=10,
                       grad_compression=True, pod_group=dist.group.WORLD)
for s in range(2):
    m = step(model, opt, synthetic_batch(7, 2 * s + RANK, 2, 16, cfg.vocab,
                                         device="cpu"))
flat = {}
def walk(tree, pre):
    for k, v in tree.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            flat[pre + k] = v
walk({"params": convert.lm_to_numpy(model),
      "ef_err": convert.opt_to_numpy(opt)["ef_err"]}, "")
save(loss=np.float32(m["loss"]), **flat)
"""


def test_grad_compression_in_a_gloo_world_matches_reference_ef():
    """Two ranks, each its own batch, two steps. The parent repeats them:
    each rank's gradients at the shared weights, the reference's
    ``error_feedback_compress`` with each rank's error, the decompressed
    summands averaged, then the port's AdamW. Each rank's error buffer
    and the weights (the same on both ranks) bit for bit."""
    import tempfile
    out = tempfile.mkdtemp(prefix="ef-world-")
    run_world(RANK_TRAIN, 2, timeout=180, out=out)
    ranks = world_results(out, 2)
    for k in ranks[0]:
        if k.startswith("params/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)

    from repro_torch.models.lm import loss_fn
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = LM.from_config(cfg, seed=0, device="cpu")
    state = adamw_init(model)
    lr = cosine_schedule(1e-3, 1, 10)
    params = dict(model.named_parameters())
    errs = [{n: jnp.zeros(p.shape, jnp.float32) for n, p in params.items()}
            for _ in range(2)]
    for s in range(2):
        avg = {n: 0.0 for n in params}
        for r in range(2):
            total, _ = loss_fn(cfg, model, synthetic_batch(
                7, 2 * s + r, 2, 16, cfg.vocab, device="cpu"))
            g = torch.autograd.grad(total, list(params.values()))
            for n, gg in zip(params, g):
                q, scale, errs[r][n] = j_ef(jnp.asarray(gg.numpy()),
                                            errs[r][n])
                avg[n] = avg[n] + np.asarray(j_decompress(q, scale))
        adamw_update(model, {n: t_of(a / np.float32(2)) for n, a in
                             avg.items()}, state, lr)
    for r in range(2):
        want = flat(convert.grads_to_numpy(
            {n: t_of(np.asarray(e)) for n, e in errs[r].items()}))
        for path, w in want.items():
            np.testing.assert_array_equal(
                ranks[r]["ef_err/" + "/".join(path)], w, (r, path))
    for path, w in flat(convert.lm_to_numpy(model)).items():
        np.testing.assert_array_equal(ranks[0]["params/" + "/".join(path)],
                                      w, path)


def test_no_group_compresses_nothing():
    """grad_compression without a group: the plain step, as the reference
    without ``pod_axis``; no error buffer."""
    from repro_torch.train import make_train_step
    cfg = get_config("tinyllama-1.1b", smoke=True)
    b = synthetic_batch(0, 0, 2, 16, cfg.vocab, device="cpu")
    out = []
    for compress in (False, True):
        model = LM.from_config(cfg, seed=0, device="cpu")
        opt = adamw_init(model)
        make_train_step(cfg, grad_compression=compress)(model, opt, b)
        assert "ef_err" not in opt
        out.append(convert.lm_to_numpy(model))
    assert_trees_close(out[1], out[0], 0.0)
