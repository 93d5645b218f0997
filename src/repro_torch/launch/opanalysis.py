"""Per-device cost analysis of one eager run: the counterpart of
``repro.launch.hloanalysis``, which reads the compiled, SPMD-partitioned
HLO. The port has no HLO, so it counts the ops of the run itself.

``analyze(fn, *args)`` runs ``fn(*args)`` once under a
``TorchDispatchMode`` and returns the reference's keys:

  * flops        mm / bmm / addmm / baddbmm / convolution as 2 prod(result)
                 K; pointwise ops, reductions and casts at 1 flop an output
                 element (the minor term)
  * hbm_bytes    the reference's streaming model: every op that is not a
                 view reads its operands once and writes its result once.
                 Eager runs no fusion, so this reads more than XLA's fused
                 module, whose fusion internals stay in registers
  * collectives  result bytes by kind of the collectives (``c10d`` and
                 ``_c10d_functional`` ops) under the reference's names:
                 all-gather, all-reduce, reduce-scatter, all-to-all, and
                 send / recv as collective-permute
  * collective_bytes, top_collectives, top_hbm (the largest contributors,
    each (bytes, kind or op, "dtype[shape]", count, op name))

and ``temp_bytes``: the high-water mark of the tensors the run made and
held at once, as the mode sees them made and freed (views and in-place
results are not new memory). It is not the allocator's figure (no
caching, no fragmentation, no workspace).

Everything is PER DEVICE: on DTensors the mode declines the DTensor-level
op and counts the local ops DTensor runs on each rank's shards, and the
collectives its redistributions make (a ``FlopCounterMode`` around a
DTensor program counts each op at its global shape). The shape inference
DTensor runs on fake tensors is not counted. Eager runs every trip of a
loop, so the reference's trip-count propagation through ``while`` bodies
has no counterpart: the counts are the run's own.
"""
from __future__ import annotations

import math
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["analyze", "OpCounter"]

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm"}
_CONVS = {"convolution", "_convolution", "conv1d", "conv2d", "conv3d"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "logsumexp", "_softmax", "_log_softmax",
               "_softmax_backward_data", "_log_softmax_backward_data",
               "cumsum", "cumprod", "norm", "linalg_vector_norm",
               "_to_copy", "embedding_dense_backward", "index_add",
               "scatter_add", "index_put"}
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("send", "collective-permute"), ("recv", "collective-permute"),
                ("broadcast", "broadcast"))
_QUIET = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(t: torch.Tensor) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


def _collective(func) -> str | None:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    if name in _QUIET:
        return ""
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return ""


class OpCounter(TorchDispatchMode):
    """The dispatch mode ``analyze`` runs under (see the module)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = defaultdict(float)
        self._top_coll = defaultdict(lambda: [0.0, 0])
        self._top_hbm = defaultdict(lambda: [0.0, 0])
        self.live = 0
        self.peak = 0

    def _freed(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op on the local shards, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out              # DTensor's shape inference
        self._count(func, ins, outs)
        return out

    def _count(self, func, ins, outs):
        name = func._schema.name.split("::")[-1]
        kind = _collective(func)
        if kind == "":
            return
        schema = func._schema
        aliased = [r.alias_info is not None for r in schema.returns]
        fresh = [t for t, a in zip(outs, aliased + [False] * len(outs))
                 if not a]
        if kind is None and not fresh:
            return                  # a view or an in-place op's self
        out_b = sum(_nbytes(t) for t in (outs if kind else fresh))
        in_b = sum(_nbytes(t) for t in ins)
        if kind:
            self.collectives[kind] += out_b
            key = (kind, _sig(outs[0]) if outs else "", name)
            self._top_coll[key][0] += out_b
            self._top_coll[key][1] += 1
        else:
            self.flops += self._flops(name, func, ins, fresh)
        self.hbm_bytes += in_b + out_b
        key = (name, _sig(fresh[0]) if fresh else "")
        self._top_hbm[key][0] += in_b + out_b
        self._top_hbm[key][1] += 1
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._freed, n)
        self.peak = max(self.peak, self.live)

    @staticmethod
    def _flops(name, func, ins, outs) -> float:
        if not outs:
            return 0.0
        res = outs[0]
        if name in _DOTS:
            a = ins[1] if name in ("addmm", "baddbmm", "addbmm") else ins[0]
            return 2.0 * res.numel() * a.shape[-1]
        if name in _CONVS:
            w = ins[1]
            return 2.0 * res.numel() * math.prod(w.shape[1:])
        if not (res.is_floating_point() or res.is_complex()):
            return 0.0
        if torch.Tag.pointwise in func.tags or name.rstrip("_") in _REDUCTIONS:
            return float(sum(t.numel() for t in outs))
        return 0.0

    def result(self) -> dict:
        top = sorted(((b, k, sig, n, op)
                      for (k, sig, op), (b, n) in self._top_coll.items()),
                     reverse=True)
        top_hbm = sorted(((b, op, sig, n, op)
                          for (op, sig), (b, n) in self._top_hbm.items()),
                         reverse=True)
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": dict(self.collectives),
                "collective_bytes": float(sum(self.collectives.values())),
                "top_collectives": top[:12], "top_hbm": top_hbm[:12],
                "temp_bytes": self.peak}


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count it (see the module).
    Returns the reference's keys, ``temp_bytes``, and ``out_bytes`` (the
    local bytes of what `fn` returned) and ``result`` (what it returned)."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    res = counter.result()
    res["out_bytes"] = sum(_nbytes(t.to_local() if isinstance(t, DTensor)
                                   else t) for t in _tensors(out))
    res["result"] = out
    return res
