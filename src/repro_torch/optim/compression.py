"""Int8 error-feedback gradient compression for the cross-group
reduction: the port of ``repro.optim.compression``.

The summand each rank contributes is quantized to int8 with one float32
scale a tensor (4x less traffic than float32); the quantization error is
kept and added to the next step's gradient (error feedback), which keeps
the sum unbiased to first order. ``train.step`` wires it behind
``grad_compression`` over a ``torch.distributed`` group. ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "error_feedback_compress"]


def compress_int8(x):
    """Per-tensor symmetric int8 quantization: (q int8, scale float32
    0-d)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def error_feedback_compress(g, err):
    """Quantize g + err; the residual is the next err. Returns (q, scale,
    new_err) with decompress(q, scale) + new_err == g + err, exactly in
    float32."""
    target = g.float() + err
    q, scale = compress_int8(target)
    return q, scale, target - decompress_int8(q, scale)
