"""PyTorch port vs the JAX package: the Mamba2 / SSD layer
(``models.mamba2``).

* ``ssd_forward`` with ``ssm_chunk`` smaller than S (several chunks and
  the carried state), equal to S and larger (one chunk), and the
  reference's error when S does not divide into chunks;
* ``mamba_forward`` (projections, causal convs, gated norm);
* ``mamba_decode`` against the reference's step, in float32 and in
  bfloat16 (the cache float32 in both, as the reference's
  ``init_mamba_cache``: the conv window and the recurrence promote to
  float32), over several steps, with the state and conv window compared
  after each.

Tolerances: float32 within 1e-5 of max |value| (sums in other orders);
bfloat16 outputs within 2e-2 of max |value| (bf16 products and casts at
other places), the float32 state within 1e-2 of max |state| (it takes
bf16 inputs whose roundings differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import np_of, one_torch_thread  # noqa: F401 (fixture)
from repro.models import mamba2 as JM
from repro_torch import get_config
from repro_torch.models import mamba2 as TM


def t_of(a):
    return torch.from_numpy(np.array(a))


def mamba_pair(arch="mamba2-780m", dtype="float32", seed=0, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              **over)
    jp = JM.init_mamba(cfg, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    rng = np.random.default_rng(seed + 5)
    # the reference zeroes conv_wb / conv_wc / conv_b and dt_bias: random
    # values here, so that every term of the layer is exercised
    for name in ("conv_wb", "conv_wc", "conv_b", "dt_bias"):
        jp[name] = jnp.asarray(rng.normal(size=jp[name].shape) * 0.3,
                               jp[name].dtype)
    mod = TM.Mamba(cfg, "cpu", getattr(torch, dtype))
    with torch.no_grad():
        for name, a in jp.items():
            getattr(mod, name).copy_(t_of(np.asarray(a, np.float32)))
    return cfg, jp, mod


def close_rel(got, want, tol):
    got, want = np_of(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("chunk,s", [(8, 32), (16, 48), (32, 32), (64, 32)])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
@torch.inference_mode()
def test_ssd_forward(arch, chunk, s):
    cfg, jp, mod = mamba_pair(arch, ssm_chunk=chunk)
    di, nh, _ = TM.dims(cfg)
    g, n, hp = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    rng = np.random.default_rng(chunk + s)
    u = rng.normal(size=(2, s, nh, hp)).astype(np.float32)
    bb = rng.normal(size=(2, s, g, n)).astype(np.float32)
    cc = rng.normal(size=(2, s, g, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, s, nh)))).astype(np.float32)
    want = JM.ssd_forward(cfg, jp, *map(jnp.asarray, (u, bb, cc, dt)))
    got = TM.ssd_forward(cfg, mod, *map(t_of, (u, bb, cc, dt)))
    assert got.dtype == torch.float32
    close_rel(got, want, 1e-5)


def test_ssd_forward_refuses_a_ragged_last_chunk():
    cfg, jp, mod = mamba_pair(ssm_chunk=8)
    di, nh, _ = TM.dims(cfg)
    args = [np.zeros((1, 12, nh, cfg.ssm_headdim), np.float32),
            np.zeros((1, 12, 1, cfg.ssm_state), np.float32),
            np.zeros((1, 12, 1, cfg.ssm_state), np.float32),
            np.ones((1, 12, nh), np.float32)]
    with pytest.raises(AssertionError, match="must divide the SSD chunk"):
        JM.ssd_forward(cfg, jp, *map(jnp.asarray, args))
    with pytest.raises(AssertionError, match="must divide the SSD chunk"):
        TM.ssd_forward(cfg, mod, *map(t_of, args))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
@torch.inference_mode()
def test_mamba_forward(arch, dtype, tol):
    cfg, jp, mod = mamba_pair(arch, dtype=dtype, ssm_chunk=8)
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = JM.mamba_forward(cfg, jp, jx)
    got = TM.mamba_forward(cfg, mod, t_of(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    close_rel(got.float(), np.asarray(want.astype(jnp.float32)), tol)


@pytest.mark.parametrize("dtype,tol,stol", [("float32", 1e-5, 1e-5),
                                            ("bfloat16", 2e-2, 1e-2)])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
@torch.inference_mode()
def test_mamba_decode(arch, dtype, tol, stol):
    """Six steps from a random float32 cache; the cache stays float32 in a
    bf16 layer, in both packages, and the port writes it in place."""
    cfg, jp, mod = mamba_pair(arch, dtype=dtype)
    rng = np.random.default_rng(3)
    jc = JM.init_mamba_cache(cfg, 2)
    tc = TM.init_mamba_cache(cfg, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    conv = rng.normal(size=jc["conv"].shape).astype(np.float32)
    state = rng.normal(size=jc["state"].shape).astype(np.float32)
    jc = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
    tc = {"conv": t_of(conv), "state": t_of(state)}
    leaves = dict(tc)
    for i in range(6):
        x = rng.normal(size=(2, 1, cfg.d_model))
        want, jc = JM.mamba_decode(cfg, jp, jnp.asarray(x, jnp.dtype(dtype)),
                                   jc)
        got, back = TM.mamba_decode(cfg, mod,
                                    t_of(x).to(getattr(torch, dtype)), tc)
        assert back is tc and got.dtype == getattr(torch, dtype)
        assert all(tc[k] is leaves[k] for k in tc)
        assert jc["conv"].dtype == jnp.float32 == jc["state"].dtype
        assert tc["conv"].dtype == torch.float32 == tc["state"].dtype
        close_rel(got.float(), np.asarray(want.astype(jnp.float32)), tol)
        close_rel(tc["state"], jc["state"], stol)
        close_rel(tc["conv"], jc["conv"], stol)
