"""PyTorch port vs the JAX package: flash attention.

``repro_torch.kernels.ops.flash_attention`` (its plain twin on the CPU)
against ``repro.kernels.ops.flash_attention`` (the Pallas kernel in
interpret mode here), and both ``attention_ref`` oracles, on the same
seeded inputs. Float32 agrees within 2e-5 absolute, the reference's own
bound between its kernel and its oracle (the sums run in other orders);
bfloat16 outputs within 1e-2 (one bf16 step of outputs near 1, the two
float32 results rounded apiece). Where a query row sees no key (Sq > Skv,
causal) both kernels' functions give 0 and both oracles NaN.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro_torch import configs as TCF
from test_torch_parity import np_of, one_torch_thread  # noqa: F401 (fixture)
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TRF

F32_TOL = 2e-5
BF16_TOL = 1e-2

# the reference's own sweep (tests/test_kernels.py)
SWEEP = [
    (1, 4, 4, 128, 128, 64, True, None),
    (2, 8, 2, 128, 128, 64, True, None),      # GQA 4:1
    (1, 4, 1, 256, 256, 32, True, None),      # MQA
    (1, 4, 4, 100, 100, 64, True, None),      # unaligned seq
    (1, 2, 2, 64, 192, 64, True, None),       # Sq < Skv (continuation)
    (1, 4, 2, 128, 128, 64, True, 32),        # sliding window
    (1, 2, 2, 96, 96, 128, False, None),      # bidirectional
]


def _qkv(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed + 7 * sq + skv + d)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _both(q, k, v, **kw):
    """(port, reference) outputs of ops.flash_attention as float32 numpy."""
    t = TO.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    j = JO.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    return np_of(t), np.asarray(j)


def _oracles(q, k, v, **kw):
    return (np_of(TRF.attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)),
            np.asarray(JR.attention_ref(*map(jnp.asarray, (q, k, v)), **kw)))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", SWEEP)
def test_flash_attention_sweep_matches_reference(b, hq, hkv, sq, skv, d,
                                                 causal, window):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d)
    kw = dict(causal=causal, window=window)
    got, want = _both(q, k, v, **kw)
    assert got.shape == (b, hq, sq, d) and got.dtype == np.float32
    assert np.abs(got - want).max() < F32_TOL
    t_ref, j_ref = _oracles(q, k, v, **kw)
    assert np.abs(t_ref - j_ref).max() < F32_TOL
    assert np.abs(got - j_ref).max() < F32_TOL


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128), (256, 256)])
def test_flash_attention_block_sizes(bq, bk):
    """The reference's block-size sweep: any (bq, bk) gives the same
    result, on both sides."""
    q, k, v = _qkv(1, 2, 2, 256, 256, 64, seed=1)
    got, want = _both(q, k, v, bq=bq, bk=bk)
    assert np.abs(got - want).max() < F32_TOL
    assert np.abs(got - _oracles(q, k, v)[1]).max() < F32_TOL


def test_flash_attention_bf16():
    q, k, v = _qkv(1, 4, 4, 128, 128, 64, seed=2)
    t = TO.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                             for x in (q, k, v)))
    assert t.dtype == torch.bfloat16
    j = JO.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert j.dtype == jnp.bfloat16
    got, want = np_of(t.float()), np.asarray(j.astype(jnp.float32))
    assert np.abs(got - want).max() < BF16_TOL


@pytest.mark.parametrize("sq,skv,window", [(192, 64, None), (100, 40, 16)])
def test_rows_without_a_key_are_zero_in_the_kernels_nan_in_the_oracles(
        sq, skv, window):
    """Sq > Skv, causal: the first Sq - Skv rows sit at negative positions
    and see no key."""
    q, k, v = _qkv(1, 4, 2, sq, skv, 64, seed=3)
    got, want = _both(q, k, v, window=window)
    t_ref, j_ref = _oracles(q, k, v, window=window)
    empty = sq - skv
    assert (got[:, :, :empty] == 0).all() and (want[:, :, :empty] == 0).all()
    assert np.isnan(t_ref[:, :, :empty]).all()
    assert np.isnan(j_ref[:, :, :empty]).all()
    assert np.isfinite(t_ref[:, :, empty:]).all()
    assert np.abs(got - want).max() < F32_TOL
    assert np.abs(got[:, :, empty:] - j_ref[:, :, empty:]).max() < F32_TOL


@pytest.mark.parametrize("blk", [16, 64])
def test_window_masks_the_first_live_tile_of_a_row(blk):
    """window blk / 2, bq = bk = blk: KV panel 0 is live for the query
    block ending at row 2 blk - 1 (its first row still reaches into it),
    yet wholly masked for that last row, whose state must come out of the
    panel unchanged (m stays -1e30, p = 0 after the exp)."""
    window, s = blk // 2, 4 * blk
    row = 2 * blk - 1
    assert blk - 1 > blk - window                 # panel 0 live for block 1
    assert blk - 1 <= row - window                # but masked for its row
    q, k, v = _qkv(1, 2, 1, s, s, 64, seed=4)
    got, want = _both(q, k, v, window=window, bq=blk, bk=blk)
    oracle = _oracles(q, k, v, window=window)[1]
    assert np.abs(got - want).max() < F32_TOL
    assert np.abs(got - oracle).max() < F32_TOL
    assert np.abs(got[:, :, row] - oracle[:, :, row]).max() < F32_TOL


@pytest.mark.parametrize("d", [16, 96, 48])
def test_twin_takes_any_head_width_on_the_cpu(d):
    """The CPU twin is not bound to the kernel's instances (48 has no
    float32 one)."""
    q, k, v = _qkv(1, 2, 2, 40, 40, d, seed=5)
    got, want = _both(q, k, v)
    assert np.abs(got - want).max() < F32_TOL


def test_cpu_calls_count_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 16, 16, 64))
    before = TF.flash_attention.launches
    TO.flash_attention(q, k, v)
    assert TF.flash_attention.launches == before


def _meta(shape, **kw):
    return torch.zeros(shape, device="meta", **kw)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, kv = _meta((1, 4, 8, 64)), _meta((1, 2, 8, 64))
    with pytest.raises(ValueError, match="no kernel"):
        TF.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head widths"):
        TF.flash_attention(_meta((1, 4, 8, 48)), _meta((1, 2, 8, 48)),
                           _meta((1, 2, 8, 48)))
    with pytest.raises(ValueError, match="forward-only"):
        TF.flash_attention(_meta((1, 4, 8, 64), requires_grad=True), kv, kv)
    cpu = torch.zeros((1, 4, 8, 64))
    with pytest.raises(ValueError, match="multiple"):
        TF.flash_attention(cpu, torch.zeros((1, 3, 8, 64)),
                           torch.zeros((1, 3, 8, 64)))
    with pytest.raises(ValueError, match="q is"):
        TF.flash_attention(cpu, torch.zeros((1, 2, 8, 64), dtype=torch.float16),
                           torch.zeros((1, 2, 8, 64), dtype=torch.float16))
    with pytest.raises(ValueError, match="dtype"):
        TF.flash_attention(*(torch.zeros((1, 2, 8, 64), dtype=torch.float64),)
                           * 3)
    with pytest.raises(ValueError, match="window"):
        TF.flash_attention(cpu, cpu, cpu, window=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_kernel_takes_the_head_of_every_configuration(dtype):
    """Every configuration whose attention reaches the kernel (heads, and
    not MLA, whose v width differs from its q width) has a head width the
    kernel takes, zamba2-7b's 112 among them; 12 and 136 are refused."""
    widths = {arch: TCF.get_config(arch).dh for arch in TCF.all_archs()
              if TCF.get_config(arch).n_heads > 0
              and not TCF.get_config(arch).mla}
    assert widths["zamba2-7b"] == 112 and len(widths) >= 8
    for arch, d in widths.items():
        assert TF.kernel_takes(d, dtype), (arch, d)
    assert not TF.kernel_takes(12, dtype)
    assert not TF.kernel_takes(136, dtype)
    assert TF.kernel_takes(80, dtype) == (dtype != torch.float32)
    assert not TF.kernel_takes(64, torch.float64)


def _rounded_p_attention(q, k, v, dtype, causal, window, bk=128):
    """The tensor-core kernel's update in float32 on the CPU: bk-key
    panels, s scaled after the product, p rounded to `dtype` before P.V,
    l summing the float32 p."""
    b, hq, sq, d = q.shape
    g, skv = hq // k.shape[1], k.shape[2]
    kf, vf = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq), -torch.inf)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for j0 in range(0, skv, bk):
        kpos = torch.arange(j0, min(j0 + bk, skv))[None, :]
        mask = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.matmul(q, kf[..., j0:j0 + bk, :].transpose(-1, -2)) / d ** 0.5
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = (acc * alpha[..., None]
               + torch.matmul(p.to(dtype).float(), vf[..., j0:j0 + bk, :]))
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


@pytest.mark.parametrize("dtype,u", [(torch.bfloat16, 2.0 ** -8),
                                     (torch.float16, 2.0 ** -11)])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (1, 4, 2, 200, 200, 64, True, None),
    (1, 2, 1, 150, 300, 32, True, 48),
    (2, 2, 2, 130, 130, 112, False, None),
])
def test_p_rounding_bound_is_sound_and_not_vacuous(dtype, u, b, hq, hkv, sq,
                                                   skv, d, causal, window):
    """Rounding p to the input type before P.V moves each output by at
    most u times the p-weighted mean of |v| (the twin applied to |v|),
    the bound the cuda test and chip_smoke.py add for 16-bit inputs; the
    emulated rounding does move the output."""
    q, k, v = (torch.from_numpy(x).to(dtype).float()
               for x in _qkv(b, hq, hkv, sq, skv, d, seed=6))
    kw = dict(causal=causal, window=window)
    exact = TF.flash_attention_ref(q, k, v, **kw)
    rounded = _rounded_p_attention(q, k, v, dtype, **kw)
    unrounded = _rounded_p_attention(q, k, v, torch.float32, **kw)
    bound = u * TF.flash_attention_ref(q, k, v.abs(), **kw)
    assert (unrounded - exact).abs().max() < F32_TOL
    err = (rounded - exact).abs()
    assert float(err.max()) > 0
    assert bool((err <= F32_TOL + bound).all())
