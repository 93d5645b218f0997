"""Flash attention: ``flash_attention``, with its plain twin
``flash_attention_ref``.

For q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) it returns softmax(q kᵀ /
sqrt(D)) v per query head, (B, Hq, Sq, D) in q's dtype, as the
reference's ``_flash_kernel`` (``flash_attention_pallas``) computes it:
query head h reads KV head h // (Hq / Hkv); query row i sits at position
i + (Skv - Sq); key j is visible when j < Skv, j <= the row's position
(``causal``) and j > the row's position - ``window``. The arithmetic is
float32: q is scaled before the product, masked scores are -1e30, an
online softmax (m, l, acc) runs over KV panels, and o = acc / max(l,
1e-30), so a row with no visible key gives 0 (``attention_ref`` gives
NaN there).

A CPU tensor takes the twin, which walks ``bk``-wide KV panels with the
reference kernel's live test and update, over the query blocks each
panel is live for. A CUDA tensor launches ``csrc/flash_attention.cu``;
any other device raises. The kernel is forward-only, as the reference's
is: on the card, an input that requires grad raises. Its launch count is
``flash_attention.launches``, and ``kernel_takes(d, dtype)`` says which
head widths it takes.

  * bfloat16 and float16 go to the tensor cores (``flash_kernel_tc``):
    one block per (batch, query head, query tile), heaviest tiles first;
    consumer warpgroups of 64 rows (three at D <= 64, two above) multiply
    by ``wgmma`` while a producer thread stages K and V by TMA through a
    two-stage ring. Any D that is a multiple of 8 up to 128 pads to 64 or
    128 columns. The bound at the LM's shape is the bf16 tensor-core
    rate. p is rounded to
    the input type before P·V, where the twin keeps float32, so the two
    differ by up to u · (the p-weighted mean of |v|) on top of float32
    rounding, u = 2^-8 (bf16) or 2^-11 (fp16).
  * float32 stays on the CUDA cores (``flash_kernel_f32``; tensor cores
    would mean TF32), for D in ``F32_HEAD_DIMS``, and agrees with the twin
    to float32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .bvh_traverse import _device_of, _stream

__all__ = ["flash_attention", "flash_attention_ref", "kernel_takes",
           "F32_HEAD_DIMS"]

#: head widths of the float32 instances: every head of the ten
#: configurations whose attention reaches the kernel (16 is the smoke
#: configurations' and the reference's test width, 112 zamba2-7b's)
F32_HEAD_DIMS = (16, 32, 64, 96, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG_INF = -1e30


def _check(what, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q must be (B, Hq, Sq, D) and k, v one "
                         f"(B, Hkv, Skv, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: k and v must share q's batch {b} and head "
                         f"width {d}, got {tuple(k.shape)}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"{what}: Hq = {hq} is not a multiple of Hkv = "
                         f"{k.shape[1]}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError(f"{what}: empty sequence (Sq = {sq}, Skv = "
                         f"{k.shape[2]})")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype must be one of "
                         f"{sorted(map(str, _DTYPES))}, got {q.dtype}")


def kernel_takes(d: int, dtype) -> bool:
    """Whether the CUDA kernel takes head width `d` in `dtype`: any
    multiple of 8 up to 128 in bfloat16 and float16 (padded to 64 or 128
    columns), ``F32_HEAD_DIMS`` in float32."""
    if dtype in (torch.bfloat16, torch.float16):
        return 8 <= d <= 128 and d % 8 == 0
    return dtype == torch.float32 and d in F32_HEAD_DIMS


def _round_up(x, m):
    return -(-x // m) * m


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale: float | None = None, bq: int = 128,
                        bk: int = 128):
    """The kernel's plain twin: the reference kernel's blocked update.

    The effective blocks are the reference wrapper's (``min(bq,
    round_up(Sq, 8))`` and likewise for bk). Each bk-wide KV panel is
    taken for the run of query blocks it is live for (the reference
    kernel's test: the panel's first key at or before the block's last
    position when causal, its last key past the block's first position
    minus the window); a panel that is wholly masked for a row leaves
    that row's state unchanged, so the blocks only save work. GQA groups
    the query heads of one KV head in a broadcast dimension."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    bq = min(bq, _round_up(sq, 8))
    bk = min(bk, _round_up(skv, 8))
    off = skv - sq
    dev = q.device
    qs = q.float().reshape(b, hkv, g, sq, d) * scale
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    m = torch.full((b, hkv, g, sq), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    qpos = torch.arange(sq, device=dev) + off
    blocks = torch.arange(0, sq, bq, device=dev)
    first_pos = blocks + off                       # per query block
    last_pos = blocks + bq - 1 + off
    for j0 in range(0, skv, bk):
        live = torch.ones_like(blocks, dtype=torch.bool)
        if causal:
            live &= j0 <= last_pos
        if window is not None:
            live &= j0 + bk - 1 > first_pos - window
        rows = torch.nonzero(live).flatten()
        if rows.numel() == 0:
            continue
        r0, r1 = int(blocks[rows[0]]), min(int(blocks[rows[-1]]) + bq, sq)
        kpos = torch.arange(j0, min(j0 + bk, skv), device=dev)[None, :]
        qp = qpos[r0:r1, None]
        mask = torch.ones((r1 - r0, kpos.shape[1]), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= kpos <= qp
        if window is not None:
            mask &= kpos > qp - window
        s = torch.matmul(qs[..., r0:r1, :],
                         kf[..., j0:j0 + bk, :].transpose(-1, -2))
        s = torch.where(mask, s, _NEG_INF)
        m_prev = m[..., r0:r1]
        m_cur = torch.maximum(m_prev, s.amax(-1))
        alpha = torch.exp(m_prev - m_cur)
        p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
        l[..., r0:r1] = l[..., r0:r1] * alpha + p.sum(-1)
        acc[..., r0:r1, :] = (acc[..., r0:r1, :] * alpha[..., None]
                              + torch.matmul(p, vf[..., j0:j0 + bk, :]))
        m[..., r0:r1] = m_cur
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(b, hq, sq, d).to(q.dtype)


_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
         + [ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    bq: int = 128, bk: int = 128):
    """(B, Hq, Sq, D) attention output in q's dtype; see the module. q, k,
    v share a dtype (float32, bfloat16, float16) and a device; on the card
    ``kernel_takes(D, dtype)`` must hold. ``bq`` and ``bk`` shape the twin's blocks (the
    reference's tiles); the kernel's tiles are its own."""
    what = "flash_attention"
    _check(what, q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be None or >= 1, got {window}")
    b, hq, sq, d = q.shape
    if q.device.type != "cpu":
        if q.requires_grad or k.requires_grad or v.requires_grad:
            raise ValueError(f"{what}: the kernel is forward-only; call it "
                             "under torch.no_grad() or torch.inference_mode()")
        if not kernel_takes(d, q.dtype):
            raise ValueError(f"{what}: the kernel takes head widths that are "
                             f"multiples of 8 up to 128 in bfloat16 and "
                             f"float16, and {F32_HEAD_DIMS} in float32; got "
                             f"{d} in {q.dtype}")
    if _device_of(q, what) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   bq=bq, bk=bk)
    dev = q.device
    a = [t.contiguous() for t in (q, k, v)]
    a = [t if t.data_ptr() % 16 == 0 else t.clone() for t in a]
    out = torch.empty_like(a[0])
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in a), out.data_ptr(), _DTYPES[q.dtype],
                 b, hq, k.shape[1], sq, k.shape[2], d, int(causal),
                 window or 0, float(1.0 / (d ** 0.5)), _stream(dev))
    _build.check("flash_attention", err, what)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
