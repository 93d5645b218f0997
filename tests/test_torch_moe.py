"""PyTorch port vs the JAX package: the MoE layer (``models.moe``).

* ``router_topk``: weights, experts and the Switch loss against the
  reference's, and the zero-router tie (every probability equal), where
  ``jax.lax.top_k`` lists the lower experts first;
* each dispatch ("dense", "gather", "ragged") against the reference's on
  the same weights and router choices, at a capacity that drops tokens
  and at one that drops none, with shared experts;
* ``moe_forward`` end to end, in float32 and bfloat16.

Tolerances: float32 outputs within 1e-5 of max |y| (sums in other
orders); bfloat16 within 2e-2 of max |y| (each product rounded to bf16
at other places), the routing itself identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import np_of, one_torch_thread  # noqa: F401 (fixture)
from repro.models import moe as JM
from repro_torch import get_config
from repro_torch.models import moe as TM


def t_of(a):
    return torch.from_numpy(np.array(a))


def moe_pair(arch="deepseek-v3-671b", dtype="float32", seed=0, **over):
    """(cfg, reference params, port MoE) with the same weights."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              **over)
    jp = JM.init_moe(cfg, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    mod = TM.MoE(cfg, "cpu", getattr(torch, dtype))
    with torch.no_grad():
        for name in ("router", "wg", "wu", "wd"):
            getattr(mod, name).copy_(t_of(np.asarray(jp[name], np.float32)))
        if "shared" in jp:
            for name, a in jp["shared"].items():
                getattr(mod.shared, name).copy_(t_of(np.asarray(a,
                                                                np.float32)))
    return cfg, jp, mod


def tokens(cfg, t, seed=1, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=(t, cfg.d_model))
    return x.astype(dtype)


def close_rel(got, want, tol):
    got, want = np_of(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
@torch.inference_mode()
def test_router_topk(arch):
    cfg, jp, mod = moe_pair(arch)
    x = tokens(cfg, 40)
    w, idx, aux = JM.router_topk(cfg, jp, jnp.asarray(x))
    tw, tidx, taux = TM.router_topk(cfg, mod, t_of(x))
    np.testing.assert_array_equal(np_of(tidx), np.asarray(idx))
    close_rel(tw, w, 1e-6)
    assert abs(float(taux) - float(aux)) <= 1e-6 * abs(float(aux))
    assert taux.dtype == torch.float32


@torch.inference_mode()
def test_zero_router_ties_go_to_the_lower_experts():
    """A zero router makes every probability 1/E: top-k lists experts 0 ..
    k-1 in order with weights 1/k, in both packages; torch.topk would
    promise no order."""
    cfg, jp, mod = moe_pair("deepseek-v3-671b")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    mod.router.zero_()
    x = tokens(cfg, 9)
    w, idx, _ = JM.router_topk(cfg, jp, jnp.asarray(x))
    tw, tidx, _ = TM.router_topk(cfg, mod, t_of(x))
    k = cfg.moe_top_k
    assert np.asarray(idx).tolist() == [list(range(k))] * 9
    np.testing.assert_array_equal(np_of(tidx), np.asarray(idx))
    np.testing.assert_allclose(np_of(tw), 1.0 / k, rtol=1e-6)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("impl", ["dense", "gather", "ragged"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
@torch.inference_mode()
def test_dispatch_matches_reference(arch, impl, cf):
    """At capacity factor 0.5 the capacity paths drop tokens (checked:
    some token's output differs from the dropless one), at the configured
    1.25 they may, at 8.0 none; the ragged path is dropless at any
    factor."""
    cfg, jp, mod = moe_pair(arch, capacity_factor=cf, moe_impl=impl)
    x = tokens(cfg, 37)
    w, idx, _ = JM.router_topk(cfg, jp, jnp.asarray(x))
    fn = {"dense": JM._moe_dense, "gather": JM._moe_gather,
          "ragged": JM._moe_ragged}[impl]
    want = np.asarray(fn(cfg, jp, jnp.asarray(x), w, idx))
    tw, tidx, _ = TM.router_topk(cfg, mod, t_of(x))
    got = {"dense": TM._moe_dense, "gather": TM._moe_gather,
           "ragged": TM._moe_ragged}[impl](cfg, mod, t_of(x), tw, tidx)
    close_rel(got, want, 1e-5)
    dropless = np.asarray(JM._moe_ragged(cfg, jp, jnp.asarray(x), w, idx))
    dropped = np.abs(want - dropless).max(1) > 1e-4 * np.abs(dropless).max()
    if cf == 0.5 and impl != "ragged":
        assert dropped.any()
    if cf == 8.0 or impl == "ragged":
        assert not dropped.any()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("impl", ["dense", "gather", "ragged"])
@torch.inference_mode()
def test_moe_forward(impl, dtype, tol):
    cfg, jp, mod = moe_pair("deepseek-v3-671b", dtype=dtype, moe_impl=impl)
    x = tokens(cfg, 2 * 11).reshape(2, 11, cfg.d_model)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want, aux = JM.moe_forward(cfg, jp, jx)
    got, taux = TM.moe_forward(cfg, mod, t_of(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    close_rel(got.float(), np.asarray(want.astype(jnp.float32)), tol)
    assert abs(float(taux) - float(aux)) <= 1e-5 * abs(float(aux))


MOE_WORLD = """
import dataclasses
from torch import nn
from repro_torch import get_config
from repro_torch.launch import mesh as M, sharding as SH
from repro_torch.models import moe as TM
from repro_torch.models.layers import set_sharding_rules

mesh = M.make_host_mesh(2, "cpu")          # (2 data, 2 model)
B, S = 4, 6
errs, rows, spill = {}, {}, {}
for arch, impl, cf in (("mixtral-8x22b", "gather", 0.5),
                       ("deepseek-v3-671b", "gather", 0.5),
                       ("mixtral-8x22b", "ragged", 0.5),
                       ("deepseek-v3-671b", "ragged", 0.5)):
    cfg = dataclasses.replace(get_config(arch, smoke=True), moe_impl=impl,
                              capacity_factor=cf, dtype="float32")
    name = f"{arch}-{impl}"
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    g = torch.randn(B, S, cfg.d_model, generator=gen)

    def model():
        m = nn.Module()
        m.moe = TM.MoE(cfg, "cpu", torch.float32)
        m.moe.init_(torch.Generator().manual_seed(5))
        return m

    plain = model()
    xp = x.clone().requires_grad_()
    yp, auxp = TM.moe_forward(cfg, plain.moe, xp)
    want = torch.autograd.grad((yp * g).sum() + auxp,
                               [xp] + list(plain.parameters()))
    # drops whose keep bit depends on the earlier data rank's tokens
    w, idx, _ = TM.router_topk(cfg, plain.moe, x.reshape(B * S, -1))
    cap = TM._capacity(cfg, B * S)
    _, _, keep = TM._slots(cfg, idx, cap)
    _, _, keep1 = TM._slots(cfg, idx[B * S // 2:], cap)
    spill[name] = int((keep1 & ~keep[B * S // 2:]).sum())

    sharded = model()
    SH.distribute_model(sharded, mesh, SH.param_specs(sharded, mesh))
    set_sharding_rules(SH.logical_rules(mesh), mesh)
    try:
        bs = SH.batch_spec(mesh, B)
        xs = SH.to_dtensor(x, mesh, bs).requires_grad_()
        TM._on_local_experts.rows = 0
        ys, auxs = TM.moe_forward(cfg, sharded.moe, xs)
        rows[name] = TM._on_local_experts.rows
        got = torch.autograd.grad(
            (ys * SH.to_dtensor(g, mesh, bs)).sum() + auxs,
            [xs] + list(sharded.parameters()))
        ys, auxs = ys.full_tensor(), auxs.full_tensor()
        got = [t.full_tensor() for t in got]
    finally:
        set_sharding_rules(None)
    errs[name] = [float((ys - yp).abs().max() / yp.abs().max()),
                  float(abs(auxs - auxp) / abs(auxp))] + [
        float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for a, b in zip(got, want)]
import json
with open(os.path.join(OUT, f"moe{RANK}.json"), "w") as f:
    json.dump({"errs": errs, "rows": rows, "spill": spill, "B": B, "S": S},
              f)
"""


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    from test_torch_parity import run_world
    out = str(tmp_path_factory.mktemp("moe_world"))
    run_world(MOE_WORLD, 4, timeout=300, out=out)
    import json
    import os
    recs = []
    for r in range(4):
        with open(os.path.join(out, f"moe{r}.json")) as f:
            recs.append(json.load(f))
    return recs


MOE_WORLD_CASES = ["mixtral-8x22b-gather", "deepseek-v3-671b-gather",
                   "mixtral-8x22b-ragged", "deepseek-v3-671b-ragged"]


@pytest.mark.parametrize("case", MOE_WORLD_CASES)
def test_sharded_dispatch_matches_unsharded(moe_world, case):
    """The gather and ragged dispatch on a (2 data, 2 model) mesh of 4 gloo
    ranks, each data rank dispatching its own rows: outputs within 1e-5 of
    max |y|, aux within 1e-5 relative, the gradients of x and of every
    weight within 1e-4 of each leaf's max, at a capacity (factor 0.5)
    where some token of the second data rank is dropped only because of
    the first rank's tokens (its keep bit needs the counts that cross
    ranks); each rank's dispatch saw its own B S / 2 rows alone."""
    for rec in moe_world:
        y, aux, *grads = rec["errs"][case]
        assert y <= 1e-5 and aux <= 1e-5, (case, y, aux)
        assert max(grads) <= 1e-4, (case, grads)
        assert rec["rows"][case] == rec["B"] * rec["S"] // 2
        if case.endswith("gather"):
            assert rec["spill"][case] > 0
