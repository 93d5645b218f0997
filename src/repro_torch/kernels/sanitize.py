"""REPRO_SANITIZE: the kernels' output contracts, checked on every call.

``REPRO_SANITIZE=1`` (read on every call: any value but "", "0" and
"false") arms the assertions below; each kernel wrapper runs its check on
what it returns, the kernel's or the twin's. The checks are the kernels'
public contracts:

  * spatial fill: counts in [0, n], collected indices in [-1, n);
  * kNN: distances not NaN and ascending per row, indices in [-1, n);
  * Karras ranges: 0 <= first <= i <= last <= n - 1 and the split gamma
    inside [first, last);
  * callback: no NaN in any float state leaf.

One input is checked too, before the launch: a walk order (``order=`` of
the spatial and kNN walks) is a permutation of the queries, since a row
it leaves out is never written.

Unarmed, a check returns before it touches a tensor, so it costs no
device synchronisation. ``karras_ranges`` also runs its twin beside the
kernel when armed and requires the two to agree bit for bit. A violated
contract raises ``AssertionError``.
"""
from __future__ import annotations

import os

import torch

__all__ = ["enabled", "check_spatial", "check_knn", "check_karras",
           "check_state_tree", "check_order"]


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0", "false")


def _fail(kernel: str, what: str):
    raise AssertionError(
        f"REPRO_SANITIZE: {kernel} violated its output contract: {what}")


def check_spatial(counts, idx_buf, *, n: int, kernel: str):
    if not enabled():
        return
    if counts.numel() and (int(counts.min()) < 0 or int(counts.max()) > n):
        _fail(kernel, f"counts outside [0, {n}]")
    if idx_buf.numel() and (int(idx_buf.min()) < -1
                            or int(idx_buf.max()) >= n):
        _fail(kernel, f"collected indices outside [-1, {n})")


def check_knn(dists, idxs, *, n: int, kernel: str):
    if not enabled():
        return
    if bool(torch.isnan(dists).any()):
        _fail(kernel, "NaN distance")
    if dists.dim() == 2 and dists.shape[1] > 1 \
            and bool((dists[:, 1:] < dists[:, :-1]).any()):
        _fail(kernel, "distances not ascending")
    if idxs.numel() and (int(idxs.min()) < -1 or int(idxs.max()) >= n):
        _fail(kernel, f"neighbor indices outside [-1, {n})")


def check_karras(first, last, gamma, *, n: int, kernel: str):
    if not enabled():
        return
    i = torch.arange(n - 1, dtype=torch.int64, device=first.device)
    first, last, gamma = (t.to(torch.int64) for t in (first, last, gamma))
    ok = ((first >= 0) & (first <= i) & (i <= last) & (last <= n - 1)
          & (gamma >= first) & (gamma < last))
    if not bool(ok.all()):
        _fail(kernel, "karras (first, last, gamma) outside the node "
                      "containment invariants")


def check_state_tree(state, *, kernel: str):
    """`state`: one tensor or a tuple / list of them, the port's layout."""
    if not enabled():
        return
    for leaf in state if isinstance(state, (tuple, list)) else (state,):
        if leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
            _fail(kernel, "NaN in callback state leaf")


def check_order(order, *, q: int, kernel: str):
    """`order`: None or a (q,) integer tensor, each of 0..q-1 once."""
    if not enabled() or order is None:
        return
    o = order.to(torch.int64)
    if o.numel() and (int(o.min()) < 0 or int(o.max()) >= q):
        raise AssertionError(f"REPRO_SANITIZE: {kernel} was given an order "
                             f"with entries outside [0, {q})")
    if not bool(torch.bincount(o, minlength=q).eq(1).all()):
        raise AssertionError(f"REPRO_SANITIZE: {kernel} was given an order "
                             f"that is not a permutation of its {q} queries")
