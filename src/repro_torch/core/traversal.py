"""The general BVH walks: spatial traversal with batched callbacks and
early exit, and the k-nearest walk (reference ``repro.core.traversal``).

Both are batched rope walks: every query holds one int32 node cursor,
and each iteration steps all live cursors at once until every cursor is
-1 (or its query is done), visiting per query the node sequence of the
reference's per-query ``lax.while_loop`` and of the kernels: at a node,
descend to the left child when the subtree may hold matches, else
escape by the rope.

Batched callback contract (every epilogue of ``callbacks`` and of the
fused kernel inherits it):

    cb(state, pred, value, index, t) -> (new_state, done)

Each iteration calls ``cb`` once on the A lanes it stepped:

  * ``state``: the lanes' rows of the per-query state, a tensor or a
    tuple of tensors with a leading axis (A, ...); bool leaves stay bool;
  * ``pred``: a predicate array of A rows (its ``data`` payload too);
  * ``value``: the values gathered at the lanes' leaf, A rows;
  * ``index``: (A,) int32 original positions of those values;
  * ``t``: (A,) float32, the ray parameter of the hit for ray
    predicates, 0 for spatial ones;
  * ``done``: (A,) bool (a Python bool broadcasts).

As in the reference, the walk applies ``cb`` to every stepped lane and
keeps the new state only where the lane hit a matching leaf; a lane at an
internal node sees the value at sorted position 0, so ``index`` is in
range on every lane. ``done`` on a hit retires the lane (ArborX's
CallbackTreeTraversalControl). Node tests and leaf tests sum squares in
the fused order (``geometry.sum_sq_fused``), and ray leaf tests take the
"walk" order of ``geometry.ray_sphere``, as XLA:CPU runs the reference's
jitted walk.

``min_pos`` is the pair-traversal filter: subtrees whose last sorted
leaf position is <= min_pos are skipped and leaves at positions <=
min_pos do not match.
"""
from __future__ import annotations

import torch

from . import predicates as P
from .access import value_at

__all__ = ["traverse", "traverse_knn", "knn_walk", "tree_select", "walk",
           "value_at"]


def _map(fn, state):
    if isinstance(state, (tuple, list)):
        return type(state)(_map(fn, s) for s in state)
    return fn(state)


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _leaves(s)]
    return [state]


def tree_select(mask, new, old):
    """Leaf by leaf ``where(mask, new, old)`` over a state (a tensor or a
    tuple of them); the (A,) mask broadcasts over trailing axes."""
    if isinstance(new, (tuple, list)):
        return type(new)(tree_select(mask, a, b) for a, b in zip(new, old))
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def walk(node_lo, node_hi, rope, left_child, range_last, leaf_perm, values,
         predicates, callback, state0, *, min_pos=None,
         stats: dict | None = None):
    """Batched spatial walk over an LBVH's arrays; returns the per-query
    final states (fresh tensors, the structure of `state0`). `stats`,
    when given, receives ``visits``: the node visits of all queries
    together."""
    q = len(predicates)
    n = leaf_perm.shape[0]
    dev = node_lo.device
    state = _map(torch.clone, state0)
    visits = 0
    mp = (torch.full((q,), -1, dtype=torch.int64, device=dev)
          if min_pos is None else min_pos.to(torch.int64))
    rope = rope.to(torch.int64)
    left = left_child.to(torch.int64)
    rlast = range_last.to(torch.int64)
    perm = leaf_perm.to(torch.int64)
    node = torch.zeros((q,), dtype=torch.int64, device=dev)
    done = torch.zeros((q,), dtype=torch.bool, device=dev)
    while True:
        act = torch.nonzero((node != -1) & ~done).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        nd = node[act]
        m = mp[act]
        pred = P.take(predicates, act)
        overlap = P.node_overlap_test(pred, node_lo[nd], node_hi[nd])
        is_leaf = nd >= n - 1
        pos = torch.clamp(nd - (n - 1), 0, n - 1)
        orig = perm[pos]
        val = value_at(values, orig)
        fine, t = P.leaf_test(pred, val, "walk")
        hit = is_leaf & overlap & fine & (pos > m)
        st = _map(lambda a: a[act], state)
        new, cb_done = callback(st, pred, val, orig.to(torch.int32), t)
        for leaf, sel in zip(_leaves(state), _leaves(tree_select(hit, new, st))):
            leaf[act] = sel.to(leaf.dtype)
        cb_done = torch.as_tensor(cb_done, dtype=torch.bool, device=dev)
        done[act] = hit & cb_done
        descend = overlap & (rlast[nd] > m) & ~is_leaf
        node[act] = torch.where(descend, left[torch.clamp_max(nd, n - 2)],
                                rope[nd])
    if stats is not None:
        stats["visits"] = visits
    return state


def traverse(tree, values, predicates, callback, state0, *, min_pos=None):
    """Per-query final states of `callback` over the matches of
    `predicates` (Intersects or a ray predicate) in `tree`; `state0` is
    batched (Q, ...)."""
    return walk(tree.node_lo, tree.node_hi, tree.rope, tree.left_child,
                tree.range_last, tree.leaf_perm, values, predicates,
                callback, state0, min_pos=min_pos)


def traverse_knn(tree, values, predicates, k: int, *, exclude_labels=None,
                 leaf_labels=None):
    """Batched k-nearest walk over `tree` (:func:`knn_walk` on its
    arrays): (dists, idxs) (Q, k)."""
    return knn_walk(tree.node_lo, tree.node_hi, tree.rope, tree.left_child,
                    tree.leaf_perm, values, predicates, k,
                    exclude_labels=exclude_labels, leaf_labels=leaf_labels)


def knn_walk(node_lo, node_hi, rope, left_child, leaf_perm, values,
             predicates, k: int, *, exclude_labels=None, leaf_labels=None,
             stats: dict | None = None):
    """Batched k-nearest walk over an LBVH's arrays: (dists, idxs) (Q, k),
    ascending FINE distances to the stored values (for ``RayNearest`` the
    hit parameter t: the first k hits), (inf, -1) padded. A subtree is
    entered while its box distance is strictly below the running k-th
    best; a leaf joins the list when its fine distance is too, before the
    equal entries. `stats`, when given, receives ``visits``: the node
    visits of all queries together.

    exclude_labels (Q,) / leaf_labels (N,): a value is a candidate for
    query q only when ``leaf_labels[index] != exclude_labels[q]``
    (Borůvka's "nearest outside my component").

    ``knn_walk.calls`` counts the calls, so a path can show that it never
    ran this host loop on the card.
    """
    knn_walk.calls += 1
    q = len(predicates)
    n = leaf_perm.shape[0]
    dev = node_lo.device
    dists = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    idxs = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    ex = (torch.full((q,), -2, dtype=torch.int32, device=dev)
          if exclude_labels is None else exclude_labels)
    rope = rope.to(torch.int64)
    left = left_child.to(torch.int64)
    perm = leaf_perm.to(torch.int64)
    node = torch.zeros((q,), dtype=torch.int64, device=dev)
    ar = torch.arange(k, device=dev)
    visits = 0
    while q:
        act = torch.nonzero(node != -1).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        nd = node[act]
        pred = P.take(predicates, act)
        tau = dists[act, k - 1]
        is_leaf = nd >= n - 1
        orig = perm[torch.clamp(nd - (n - 1), 0, n - 1)]
        promising = P.node_min_distance(pred, node_lo[nd], node_hi[nd]) < tau
        d = P.leaf_distance(pred, value_at(values, orig), fused=True)
        ok = is_leaf & promising & (d < tau)
        if leaf_labels is not None:
            ok = ok & (leaf_labels[orig] != ex[act])
        rows = act[ok]
        if rows.numel():
            dd = d[ok][:, None]
            oi = orig[ok].to(torch.int32)[:, None]
            cur_d, cur_i = dists[rows], idxs[rows]
            at = (cur_d < dd).sum(1, keepdim=True)
            shift_d = torch.cat([dd, cur_d[:, :-1]], 1)
            shift_i = torch.cat([oi, cur_i[:, :-1]], 1)
            dists[rows] = torch.where(ar < at, cur_d,
                                      torch.where(ar == at, dd, shift_d))
            idxs[rows] = torch.where(ar < at, cur_i,
                                     torch.where(ar == at, oi, shift_i))
        descend = promising & ~is_leaf
        node[act] = torch.where(descend, left[torch.clamp_max(nd, n - 2)],
                                rope[nd])
    if stats is not None:
        stats["visits"] = visits
    return dists, idxs


knn_walk.calls = 0
