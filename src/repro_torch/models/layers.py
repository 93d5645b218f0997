"""Shared neural layers of the LM: norms, RoPE, MLPs, embedding and tied
logits, and the truncated-normal initialiser. The port of
``repro.models.layers``, as functions over tensors, and the two
parameter modules every block kind holds, ``Norm`` and ``MLP``; the
training side's ``cross_entropy`` and the RMSNorm's backward
(``_RMSNorm``, the reference's custom VJP).

Each follows the reference's arithmetic where PyTorch's defaults differ:
the norms compute in float32 with eps = 1e-6 (LayerNorm with the
population variance, as ``jnp.var``), GELU is the tanh approximation
(``jax.nn.gelu``'s default) and RoPE rotates interleaved pairs
(``x[..., 0::2]``, ``x[..., 1::2]``) over the first ``rotary_pct`` of the
head, with float32 angles.

Sharding: activations are annotated with logical axis names through
``shard(x, *names)`` at the reference's call sites; ``launch.sharding``
installs the logical -> mesh-axis rules (``set_sharding_rules``).
Outside a rules context, or on a plain tensor, ``shard`` is a no-op, so
the same model code runs on one device and on a mesh. Inside one, a
DTensor is redistributed to the rule's placements. Where the reference's
``with_sharding_constraint`` is a hint to the partitioner, a
``redistribute`` is a collective: a ``Partial`` sum reduced at another
place than XLA's changes the order of the float sum (the tests state the
tolerance that follows).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["set_sharding_rules", "logical_spec", "shard", "sharding_mesh",
           "local_offset", "hold_gradient",
           "trunc_normal", "rms_norm", "layer_norm", "apply_norm",
           "rope_freqs", "apply_rope", "apply_mlp", "embed_tokens",
           "logits_out", "cross_entropy", "Norm", "MLP"]

EPS = 1e-6

# ---------------------------------------------------------------------------
# logical-axis sharding
# ---------------------------------------------------------------------------

_RULES: dict | None = None
_MESH = None


def set_sharding_rules(rules: dict | None, mesh=None):
    """Install logical -> mesh axis rules on `mesh` (None disables the
    annotations). While rules are installed, a plain tensor that meets a
    DTensor in an op counts as replicated (DTensor's implicit
    replication): the positions, RoPE's angles and the masks the model
    makes with ``torch.arange`` are the same on every rank."""
    global _RULES, _MESH
    _RULES = rules
    _MESH = mesh if rules is not None else None
    DTensor._op_dispatcher._allow_implicit_replication = rules is not None


def sharding_mesh():
    """The mesh the installed rules map onto; None outside a rules
    context."""
    return _MESH


def local_offset(t, mesh, dim: int) -> int:
    """The global index of this rank's first entry of DTensor `t` along
    `dim` (torch.chunk's layout, which is JAX's for the even splits the
    rules make)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)[1][dim]


def logical_spec(*names):
    """The ``launch.sharding.PartitionSpec`` of logical axis names under
    the installed rules."""
    from ..launch.sharding import PartitionSpec
    if _RULES is None:
        return PartitionSpec(*([None] * len(names)))
    return PartitionSpec(*[_RULES.get(n) if n is not None else None
                           for n in names])


class _GradAt(torch.autograd.Function):
    """The identity, whose gradient is redistributed to `placements`: the
    transpose of a sharding constraint, which holds the gradient where
    the value is held (Megatron's all-reduce of the input gradient of a
    column-parallel block). Left to itself, a residual stream's gradient
    stays a ``Partial`` sum over "model", and DTensor's product rule then
    gathers the next column-parallel weight whole and runs the full
    product on each rank rather than reduce the gradient."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def hold_gradient(x):
    """`x`, whose gradient is redistributed to `x`'s own placements (a
    plain tensor is `x`)."""
    if not isinstance(x, DTensor) or not (torch.is_grad_enabled()
                                          and x.requires_grad):
        return x
    return _GradAt.apply(x, tuple(x.placements))


def shard(x, *names):
    """`x` redistributed to the placements of its logical axes under the
    installed rules, and an activation's gradient to the same placements
    (as ``with_sharding_constraint`` constrains both); `x` itself outside a
    rules context or when it is not a DTensor. A dim that its mesh axes
    do not divide is split unevenly, as torch.chunk splits (the
    reference's partitioner pads it)."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    from ..launch.sharding import named
    want = named(_MESH, logical_spec(*names))
    # an activation's, not a weight's: a weight's gradient keeps its own
    # partial sums, which the optimizer reduces where it takes them
    activation = x.grad_fn is not None
    if tuple(x.placements) != want:
        x = x.redistribute(_MESH, want)
    if activation and torch.is_grad_enabled():
        x = _GradAt.apply(x, want)
    return x


# ---------------------------------------------------------------------------
# initializers and layers
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, scale: float, dtype):
    """A standard normal truncated to [-2, 2], times `scale`, drawn in
    float32 from `gen` on its device and cast to `dtype` (the reference's
    ``trunc_normal``; the numbers differ, the distribution is the same)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's custom VJP (``layers._rmsnorm``): the
    forward keeps x in its own dtype and the float32 rstd (B, S, 1), not
    the float32 panels autograd would keep, and the backward gives dx in
    x's dtype and dscale summed over every axis but the last."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, rstd, scale)
        return (xf * rstd * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, rstd, scale = ctx.saved_tensors
        xhat = x.float() * rstd
        gf = g.float()
        gs = gf * scale
        dot = (gs * xhat).mean(-1, keepdim=True)
        dx = ((gs - xhat * dot) * rstd).to(x.dtype)
        dscale = gf * xhat
        if x.dim() > 1:
            dscale = dscale.sum(tuple(range(x.dim() - 1)))
        return dx, dscale.to(scale.dtype), None


def rms_norm(x, scale, eps: float = EPS):
    """x / rms(x) * scale in float32, cast back to x's dtype; through
    ``_RMSNorm`` whenever a gradient is taken."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = EPS):
    """(x - mean) / sqrt(population variance + eps) * scale + bias in
    float32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _summed(x):
    """`x` with every pending ``Partial`` sum of a DTensor reduced: a norm
    is not linear, and DTensor's rules let a partial sum through one into
    the next product (the decoder block of encdec adds two partial
    attention outputs into x before its norms, as the reference's does)."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def apply_norm(x, scale, bias=None, kind: str = "rmsnorm", eps: float = EPS):
    x = _summed(x)
    if kind == "rmsnorm":
        return rms_norm(x, scale, eps)
    return layer_norm(x, scale, bias, eps)


def rope_freqs(dh_rot: int, theta: float, device=None):
    """(dh_rot // 2,) float32 inverse frequencies."""
    e = torch.arange(0, dh_rot, 2, dtype=torch.float32, device=device) / dh_rot
    # theta filled on the device: a tensor made from a host value would be
    # a copy, and a decode step makes none
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), e)


def apply_rope(x, positions, theta: float, rotary_pct: float = 1.0):
    """x: (..., S, dh); positions: (S,). Rotates the interleaved pairs of
    the first rotary_pct of dh (chatglm's partial rope at 0.5)."""
    dh = x.shape[-1]
    dh_rot = int(dh * rotary_pct)
    dh_rot -= dh_rot % 2
    if dh_rot == 0:
        return x
    inv = rope_freqs(dh_rot, theta, x.device)
    ang = positions[..., :, None].float() * inv              # (S, dh_rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :dh_rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, x[..., dh_rot:]], dim=-1)


def apply_mlp(x, wu, wd, wg=None, kind: str = "swiglu"):
    """SwiGLU (silu(x wg) * (x wu)) wd, or GELU-tanh (x wu) wd; weights
    are (d_in, d_out)."""
    if kind == "swiglu":
        h = F.silu(x @ wg) * (x @ wu)
    else:
        h = F.gelu(x @ wu, approximate="tanh")
    if h.dim() == 3:
        h = shard(h, "batch", None, "ffn")
    else:                              # (tokens, ffn): the MoE's shared MLP
        h = shard(h, "batch", "ffn")
    return h @ wd


class _SumOver(torch.autograd.Function):
    """The sum of each rank's `x` over a process group, whose gradient is
    the output's gradient unchanged: the sum is replicated, so every rank
    holds the whole gradient of its own summand."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def embed_tokens(table, tokens):
    """The rows of `table` at `tokens`. Under a mesh, on a table sharded
    over the vocabulary, each rank looks up the tokens of its own rows
    (zeros elsewhere) and the rows are summed over "model" (Megatron's
    vocabulary-parallel embedding, under ``local_map``: DTensor's own rule
    for it cannot take the gradient of a tied table, a ``Partial`` sum
    into its masked partial)."""
    table = shard(table, "vocab", None)
    if _MESH is None or not isinstance(table, DTensor):
        return table[tokens]
    from torch.distributed.tensor.experimental import local_map
    lo = local_offset(table, _MESH, 0)
    rows = table.to_local().shape[0]
    groups = [_MESH.get_group(i) for i, p in enumerate(table.placements)
              if p == Shard(0)]

    def lookup(tab, tok):
        mine = (tok >= lo) & (tok < lo + rows)
        x = tab[torch.where(mine, tok - lo, 0)]
        x = x * mine[..., None].to(x.dtype)
        for g in groups:
            x = _SumOver.apply(x, g)
        return x

    # a data rank's table gradient is its own tokens' share: a partial sum
    grad = [Partial() if k == Shard(0) else t
            for t, k in zip(table.placements, tokens.placements)]
    return local_map(lookup, out_placements=list(tokens.placements),
                     in_placements=(table.placements, tokens.placements),
                     in_grad_placements=(grad, tokens.placements),
                     device_mesh=_MESH)(table, tokens)


def logits_out(table, x):
    """Tied, vocabulary-parallel logits: (B, S, d) @ (d, V)."""
    return shard(x @ table.T.to(x.dtype), "batch", None, "vocab")


def cross_entropy(logits, labels, ignore_id: int = -100):
    """Mean token cross-entropy in float32 over the labels that are not
    `ignore_id`: the label's logit gathered at ``labels.clamp(min=0)``,
    the masked sum over max(count, 1). A 0-d device tensor; no host
    sync."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if _MESH is not None and isinstance(lf, DTensor):
        # over a vocabulary sharded on "model": the label's logit as a
        # masked sum, which adds zeros to one value and so is exact
        # (DTensor's gather over a sharded dim reduces a 2-d mask into
        # a 3-d tensor and fails)
        hit = torch.arange(lf.shape[-1], device=lf.device) \
            == labels.clamp(min=0)[..., None]
        ll = torch.where(hit, lf, 0.0).sum(-1)
    else:
        ll = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels != ignore_id
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


class Norm(nn.Module):
    """RMSNorm (scale) or LayerNorm (scale, bias); float32 parameters."""

    def __init__(self, d: int, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = (nn.Parameter(torch.zeros(d, device=device))
                     if kind != "rmsnorm" else None)

    def forward(self, x):
        return apply_norm(x, self.scale, self.bias, self.kind)


class MLP(nn.Module):
    """SwiGLU (wg, wu, wd) or GELU (wu, wd), (d_in, d_out) weights."""

    def __init__(self, d: int, d_ff: int, kind: str, device=None, dtype=None):
        super().__init__()
        self.kind = kind
        shapes = {"wu": (d, d_ff), "wd": (d_ff, d)}
        if kind == "swiglu":
            shapes = {"wg": (d, d_ff), **shapes}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype)))

    @torch.no_grad()
    def init_(self, gen: torch.Generator):
        for w in self.parameters():
            w.copy_(trunc_normal(gen, w.shape, w.shape[0] ** -0.5, w.dtype))

    def forward(self, x):
        return apply_mlp(x, self.wu, self.wd, getattr(self, "wg", None),
                         self.kind)
