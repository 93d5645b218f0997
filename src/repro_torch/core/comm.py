"""Collectives over a ``torch.distributed`` process group: what
``shard_map`` and ``jax.lax`` gave the reference's distributed index.

The reference is single-controller: one process holds a (mesh, axis)
pair and runs a program per shard. PyTorch is multi-controller: one
process per rank, and a process group stands for the mesh axis (rank r
of the group is shard r). Every function here is a collective: every
rank of the group calls it, in the same order, with tensors of the same
shape and dtype. Callers settle lengths first with :func:`agree`, so a
check that could come out differently on different ranks is decided
after one small collective and every rank raises together.

Where the tensors travel is decided by the group's backend:

  * NCCL passes device tensors; a tensor that is not on a CUDA device
    raises (an NCCL group needs an index on the card).
  * gloo passes host tensors: a CUDA tensor is copied to the host,
    exchanged there, and copied back to its device.

``group=None`` means the default group (``init_process_group``'s).

Failures are agreed, not thrown alone: a step that may fail on one rank
runs inside a ``try``, the rank takes part in the next collective all the
same (with a failure flag in it, or through :func:`check_all`), and
:func:`raise_together` then raises :class:`RankFailure` on every rank at
once. A rank that raised alone would leave the others waiting in a
collective until the group's timeout, and the group out of step after it.

A leader (rank 0 of the group) hands work to the other ranks with
:func:`broadcast_object`: a :class:`Work` (one serving group, or a
control message), or an index build or update.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from . import geometry as G

__all__ = ["group_of", "size", "rank", "is_nccl", "check_device", "agree",
           "all_gather", "all_gather_varlen", "stack", "all_to_all",
           "all_reduce_sum", "fold", "tree_map", "RankFailure",
           "raise_together", "check_all", "broadcast_object", "Work",
           "NOP", "STOP"]


def group_of(group):
    """`group`, or the default group for None; raises when
    ``torch.distributed`` has not been initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("no process group: call torch.distributed."
                         "init_process_group on every rank first")
    return group if group is not None else dist.group.WORLD


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in `group` (raises when it is not a member)."""
    r = dist.get_rank(group)
    if r < 0:
        raise ValueError("this process is not a member of the group")
    return r


def is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def check_device(group, device: torch.device):
    """An NCCL group moves device tensors only: refuse an index that
    lives elsewhere."""
    if is_nccl(group) and device.type != "cuda":
        raise ValueError(f"an NCCL group passes CUDA tensors, and this index "
                         f"lives on {device}; use a gloo group for the CPU")


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """`t` as the group's backend takes it: on its device for NCCL, on
    the host for gloo."""
    if is_nccl(group):
        if not t.is_cuda:
            raise ValueError("an NCCL group passes CUDA tensors; got one on "
                             f"{t.device}")
        return t.contiguous()
    return t.detach().contiguous().cpu()


def agree(group, values, device) -> torch.Tensor:
    """(R, len(values)) int64 table of every rank's `values` (small ints:
    lengths, flags) on the host, so every rank takes the same decision."""
    dev = device if is_nccl(group) else torch.device("cpu")
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    return stack(group, t).cpu()


def _gathered(group, t: torch.Tensor) -> torch.Tensor:
    """(R, *t.shape): every rank's `t`, stacked in rank order, on `t`'s
    device."""
    x = _wire(group, t)
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts).to(t.device)


def stack(group, tree):
    """Every rank's `tree` (tensors, or a container of them), each tensor
    given a leading (R,) axis in rank order."""
    return tree_map(lambda t: _gathered(group, t), tree)


def all_gather(group, tree):
    """Every rank's `tree` concatenated along axis 0 in rank order (a
    tiled all-gather)."""
    def one(t):
        g = _gathered(group, t)
        return g.reshape((g.shape[0] * g.shape[1],) + g.shape[2:])
    return tree_map(one, tree)


def all_gather_varlen(group, t: torch.Tensor, lengths) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0 in rank order, where
    rank r's `t` has lengths[r] rows (the lengths :func:`agree` gave)."""
    most = max(int(n) for n in lengths)
    pad = t.new_zeros((most - t.shape[0],) + t.shape[1:])
    g = _gathered(group, torch.cat([t, pad]))
    return torch.cat([g[r, :int(n)] for r, n in enumerate(lengths)])


def all_to_all(group, tree):
    """Exchange along the leading (R,) axis: row s of the result on rank r
    is row r of rank s's input."""
    def one(t):
        x = _wire(group, t)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out.to(t.device)
    return tree_map(one, tree)


def fold(rows, combine):
    """``combine`` folded left to right over the (R, ...) leading axis of
    a tensor or a container of them: combine(...combine(row 0, row 1)...,
    row R-1)."""
    n = _leading(rows)
    acc = tree_map(lambda a: a[0], rows)
    for r in range(1, n):
        acc = combine(acc, tree_map(lambda a, r=r: a[r], rows))
    return acc


def all_reduce_sum(group, tree):
    """The elementwise sum of every rank's `tree`, on every rank, added
    in rank order: ((x_0 + x_1) + x_2) + ..., the order ``psum`` takes
    on the reference's CPU mesh, so float sums round alike."""
    return fold(stack(group, tree), _add)


def _add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def _leading(tree) -> int:
    out = []
    tree_map(lambda t: out.append(t.shape[0]), tree)
    return out[0]


def tree_map(fn, tree, *rest):
    """`fn` over the tensors of `tree`: a tensor, a geometry array (a
    k-DOP's shared directions kept whole), a predicate or other dataclass
    (fields that hold no tensor, such as k, kept), or a dict / tuple /
    list of them; None stays None. `rest` are trees of the same
    structure, their tensors passed alongside."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, G.KDOPs):
        return G.KDOPs(fn(tree.lo, *(r.lo for r in rest)),
                       fn(tree.hi, *(r.hi for r in rest)), tree.directions)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"cannot map over {type(tree).__name__}")


# ---------------------------------------------------------------------------
# agreed failures
# ---------------------------------------------------------------------------

class RankFailure(RuntimeError):
    """A step failed on one or more ranks of a group. Every rank raises it
    together, after the collective that told them all; ``ranks`` lists the
    ranks where it failed, and the message quotes each one's error."""

    def __init__(self, message: str, ranks):
        super().__init__(message)
        self.ranks = list(ranks)


def raise_together(group, failed, error, what: str):
    """Raise :class:`RankFailure` on every rank when any of `failed` is
    set: one flag a rank, in rank order, from a collective every rank
    took part in. The ranks' error texts are all-gathered first (one more
    collective, which every rank takes, since every rank saw the same
    flags), so the message names each failed rank's own error; this
    rank's `error` is the exception's cause."""
    bad = [r for r, f in enumerate(np.asarray(failed).tolist()) if f]
    if not bad:
        return
    texts = [None] * size(group)
    mine = None if error is None else f"{type(error).__name__}: {error}"
    dist.all_gather_object(texts, mine, group=group)
    detail = "; ".join(f"rank {r}: {texts[r]}" for r in bad)
    raise RankFailure(f"{what} failed on rank(s) {bad} ({detail})",
                      bad) from error


def check_all(group, error, device, what: str):
    """One collective: every rank raises :class:`RankFailure` together
    when `error` (this rank's exception, or None) is set on any rank."""
    raise_together(group, agree(group, [error is not None], device)[:, 0],
                   error, what)


# ---------------------------------------------------------------------------
# the leader's broadcasts
# ---------------------------------------------------------------------------

def _leader(group) -> int:
    """The global rank of rank 0 of `group`, the broadcasts' source."""
    return dist.get_global_rank(group, 0)


def broadcast_object(group, obj=None):
    """Rank 0's picklable `obj` on every rank (the others pass None).
    Tensors in it travel pickled, so pass them on the host."""
    box = [obj]
    dist.broadcast_object_list(box, src=_leader(group), group=group)
    return box[0]


NOP, STOP = "nop", "stop"


@dataclasses.dataclass(frozen=True)
class Work:
    """One unit of the leader's work, sent with :func:`broadcast_object`:
    a serving group (its kind, k, bucket, real rows, the members' (rid,
    start, m) rows, the index name, the version the leader pinned, and
    the bucket's float32 `a` / `b` arrays) or a control message (kind
    NOP or STOP, nothing else set)."""
    kind: str
    k: int = 0
    bucket: int = 0
    n_real: int = 0
    members: tuple = ()
    index: str = ""
    version: int = 0
    a: np.ndarray | None = None
    b: np.ndarray | None = None
