"""The rules that let the k-nearest kernels visit candidates in their own
order and still equal their plain twins bit for bit, held on the CPU
against numpy oracles:

  * ``bvh_traverse_knn_ref`` (the rope walk) reaches leaves in ascending
    sorted-leaf position, admits a leaf only when d2 < the k-th (strict)
    and places it before the equal entries. Its list is every leaf with d2
    below D, the k-th smallest d2, and of the leaves at D the m = k -
    #{d2 < D} with the highest positions among the first k leaves with
    d2 <= D in position order; ordered by d2, then position descending.
    That is not a fixed order on (d2, position): which leaves at D stay
    depends on where the nearer leaves lie. Held against a numpy oracle of
    the rule on duplicate-heavy clouds, a grid with queries on and off it,
    Points and Boxes values, dims 1 to 16, k up to 256, N from 2, and
    queries holding inf or NaN. A scalar transcription of
    ``csrc/bvh_traverse.cu``'s nearest-first walk (the k smallest by (d2,
    position descending), then its tie pass) gives the same lists, with
    its stack never deeper than the tree's internal depth;
  * ``bruteforce_knn_ref`` (a stable sort over ascending indices) is the k
    smallest by (d2, index), and equals a merge, in chunk order and by
    that key, of per-chunk lists over chunks cut as
    ``csrc/bruteforce_knn.cu`` cuts them (one boundary at ``tail_from``),
    for 1, 2, 7 and 32 chunks, the reference's k > N tail included;
  * ``csrc/knn_list.cuh``'s heap, transcribed, keeps the k smallest keys;
  * the LBVH's internal nodes stay within the walk's stack bound on
    adversarial builds, and a left child's rope is its right sibling, which
    the 3-D kNN instance reads as the right child.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import morton as M
from repro_torch.kernels import bvh_traverse as TT

TB = importlib.import_module("repro_torch.kernels.bruteforce_knn")

INF = np.float32(np.inf)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _cloud(n, dim, seed, kind):
    """(lo, hi) of n float32 values: uniform points with every fourth equal
    to the first (duplicate Morton codes, ties at d2 = 0), or boxes."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, dim), dtype=np.float32)
    if kind == "dup_points":
        x[::4] = x[0]
        return x, x
    if kind == "boxes":
        side = (0.2 * rng.random((n, dim), dtype=np.float32)).astype(np.float32)
        x[::5] = x[0]
        return x, (x + side).astype(np.float32)
    return x, x


def _grid(dim):
    """Grid points spaced 0.1 apart (not exact in binary): many pair
    distances tie or sit an ulp apart."""
    m = 9 if dim == 2 else 5
    ax = (np.arange(m, dtype=np.float32) * np.float32(0.1)).astype(np.float32)
    g = np.stack(np.meshgrid(*([ax] * dim), indexing="ij"), -1)
    return g.reshape(-1, dim).astype(np.float32)


def _tree(lo, hi):
    return TL.build(TG.Boxes(torch.from_numpy(lo), torch.from_numpy(hi)))


def _queries(lo, q, seed, special=True):
    """q queries: half on the values' lower corners, half uniform, and
    (with `special`) rows holding +inf, -inf and NaN."""
    rng = np.random.default_rng(seed + 1)
    n, dim = lo.shape
    on = lo[rng.integers(0, n, q // 2)]
    off = rng.random((q - q // 2, dim), dtype=np.float32)
    out = np.concatenate([on, off]).astype(np.float32)
    if special and q >= 4:
        out[0, 0] = np.inf
        out[1, -1] = -np.inf
        out[2, 0] = np.nan
    return out


def _node_d2(tree, qs):
    """(Q, 2N-1) float32 squared query-to-node-box distances, in the
    walks' order (max(max(lo - q, q - hi), 0), then g0*g0 and one fused
    multiply-add per further dimension)."""
    q = torch.from_numpy(qs)[:, None, :]
    g = torch.clamp_min(torch.maximum(tree.node_lo[None] - q,
                                      q - tree.node_hi[None]), 0.0)
    return TG.sum_sq_fused(g).numpy()


def _tie_rule(d2, k):
    """Sorted-leaf positions of the twin's list for one query's leaf
    distances `d2` (N,), in its order: every leaf below D (the k-th
    smallest d2), then of the leaves at D the m = k - #{d2 < D} with the
    highest positions among the first k leaves with d2 <= D in position
    order; by d2, then position descending. inf and NaN never enter."""
    pos = np.arange(len(d2))
    ok = d2 < np.inf
    if ok.sum() <= k:
        keep = pos[ok]
    else:
        big = np.sort(d2[ok])[k - 1]
        below = pos[ok & (d2 < big)]
        first_k = pos[ok & (d2 <= big)][:k]
        at = first_k[d2[first_k] == big]
        keep = np.concatenate([below, at[len(at) - (k - len(below)):]])
    return keep[np.lexsort((-keep, d2[keep]))]


def _rule_oracle(tree, qs, k):
    """(dists, idxs) of the tie rule for every query, (inf, -1) padded."""
    n = tree.num_leaves
    d2 = _node_d2(tree, qs)[:, n - 1:]
    perm = tree.leaf_perm.numpy()
    out_d = np.full((len(qs), k), INF, np.float32)
    out_i = np.full((len(qs), k), -1, np.int32)
    for r in range(len(qs)):
        keep = _tie_rule(d2[r], k)
        out_d[r, :len(keep)] = d2[r][keep]
        out_i[r, :len(keep)] = perm[keep]
    return TG.sqrt(torch.from_numpy(out_d)), torch.from_numpy(out_i)


def _twin(tree, qs, k):
    return TT.bvh_traverse_knn_ref(tree.node_lo, tree.node_hi, tree.rope,
                                   tree.left_child, tree.leaf_perm,
                                   torch.from_numpy(qs), k=k)


def _depths(tree):
    """(N-1,) depth of each internal node (root 0)."""
    n = tree.num_leaves
    left, right = tree.left_child.numpy(), tree.right_child.numpy()
    depth = np.full(n - 1, -1, np.int64)
    stack = [(0, 0)]
    while stack:
        m, d = stack.pop()
        depth[m] = d
        for c in (left[m], right[m]):
            if c < n - 1:
                stack.append((c, d + 1))
    return depth


# ---------------------------------------------------------------------------
# the kNN walk
# ---------------------------------------------------------------------------

KEY_CASES = [(kind, n, dim)
             for kind in ("dup_points", "boxes")
             for n, dim in ((2, 3), (3, 1), (17, 2), (17, 5), (5000, 3),
                            (600, 16), (800, 1), (900, 2))]


@pytest.mark.parametrize("k", [1, 10, 33, 256])
@pytest.mark.parametrize("kind,n,dim", KEY_CASES)
def test_knn_twin_follows_the_tie_rule(kind, n, dim, k):
    lo, hi = _cloud(n, dim, seed=n + dim, kind=kind)
    tree = _tree(lo, hi)
    qs = _queries(lo, 24, seed=n)
    got = _twin(tree, qs, k)
    want = _rule_oracle(tree, qs, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_knn_twin_keeps_later_leaves_at_the_kth_distance():
    """Why the walk needs its tie pass: two points at one distance from the
    query and a nearer one, k = 2. When the nearer point comes last in
    position order, the rope walk takes both ties and the nearer point
    evicts the earlier one, so the later tie stays, where the k smallest
    by (d2, position) would keep the earlier; when the nearer point comes
    first, the second tie is rejected and the earlier stays."""
    def run(xs):
        x = np.asarray(xs, np.float32)
        tree = _tree(x, x)
        q = np.zeros((1, 2), np.float32)
        return tree.leaf_perm.tolist(), _twin(tree, q, 2)[1][0].tolist()

    ties = [(0.5, 0.0), (-0.5, 0.0)]
    # positions: the ties at 0 and 1, the nearer point at 2
    assert run(ties + [(0.25, 0.25)]) == ([1, 0, 2], [2, 0])
    # positions: the nearer point at 0, the ties at 1 and 2
    assert run(ties + [(-0.25, -0.25)]) == ([2, 1, 0], [2, 1])


@pytest.mark.parametrize("k", [1, 10, 33, 256])
@pytest.mark.parametrize("dim", [2, 3])
def test_knn_twin_follows_the_tie_rule_on_a_grid(dim, k):
    """Queries on the grid points (ties at d2 = 0 and at each spacing) and
    off them."""
    g = _grid(dim)
    tree = _tree(g, g)
    rng = np.random.default_rng(dim)
    qs = np.concatenate([g[::7], (g[::5] + np.float32(0.05)).astype(np.float32),
                         rng.random((8, dim), dtype=np.float32)])
    got = _twin(tree, qs, k)
    want = _rule_oracle(tree, qs, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _nearest_first(tree, d2, k):
    """A scalar transcription of csrc/bvh_traverse.cu's knn_kernel for one
    query's node distances `d2` (2N-1,): (dists, idxs, node tests, deepest
    stack, whether the tie pass ran). Admission and pruning are the twin's
    strict d2 < tau; an insert lands by (d2, position descending), as
    knn_list.cuh's KeyList<K, true>."""
    n = tree.num_leaves
    left, rope = tree.left_child.numpy(), tree.rope.numpy()
    perm = tree.leaf_perm.numpy()
    best = [(INF, -1)] * k          # ascending by (d2, -position)
    lost = INF                      # the smallest d2 left out

    def less(a, b):
        return a[0] < b[0] or (a[0] == b[0] and a[1] > b[1])

    def takes(d):
        return d < best[k - 1][0]

    def leave(d):
        nonlocal lost
        if d < lost:                # NaN compares false: dropped, as fminf
            lost = d

    stack, deepest, tests = [], 0, 1
    go = takes(d2[0])
    link = left[0]
    leaf0 = n - 1
    while go:
        lc = link
        rc = rope[lc]             # a left child's rope: its right sibling
        dl, dr = d2[lc], d2[rc]
        tests += 2
        for c, d in ((lc, dl), (rc, dr)):
            if c < leaf0:
                continue
            if takes(d):
                leave(best[k - 1][0])
                at = sum(less(e, (d, c - leaf0)) for e in best)
                best = best[:at] + [(d, c - leaf0)] + best[at:k - 1]
            else:
                leave(d)
        go_l = lc < leaf0 and takes(dl)
        go_r = rc < leaf0 and takes(dr)
        for c, d, g in ((lc, dl, go_l), (rc, dr, go_r)):
            if c < leaf0 and not g:
                leave(d)
        if go_l and go_r:
            near, far = (lc, rc) if dl <= dr else (rc, lc)
            stack.append((d2[far], left[far]))
            deepest = max(deepest, len(stack))
            link = left[near]
        elif go_l or go_r:
            link = left[lc] if go_l else left[rc]
        else:
            go = False
            while stack:
                d, lk = stack.pop()
                if takes(d):
                    link, go = lk, True
                    break
                leave(d)
    dk = best[k - 1][0]
    tie_pass = lost == dk and dk != INF
    if tie_pass:                  # the first k leaves with d2 <= dk, by position
        below = sum(e[0] < dk for e in best)
        ring, seen, node = [], 0, 0
        while node != -1 and seen < k:
            if not d2[node] <= dk:
                node = rope[node]
            elif node < leaf0:
                node = left[node]
            else:
                seen += 1
                if d2[node] == dk:
                    ring.append(node - leaf0)
                node = rope[node]
        best = best[:below] + [(dk, p) for p in ring[::-1][:k - below]]
    dd = np.array([e[0] for e in best], np.float32)
    ii = np.array([perm[e[1]] if e[1] >= 0 else -1 for e in best], np.int32)
    return dd, ii, tests, deepest, tie_pass


@pytest.mark.parametrize("k", [1, 2, 10, 33])
@pytest.mark.parametrize("kind,n,dim", [("dup_points", 5000, 3),
                                        ("boxes", 5000, 3),
                                        ("dup_points", 17, 2),
                                        ("dup_points", 2, 3),
                                        ("points", 3000, 5),
                                        ("grid", 0, 2)])
def test_nearest_first_walk_gives_the_twins_lists(kind, n, dim, k):
    """The kernel's walk, transcribed: the twin's lists bit for bit, fewer
    node tests than the rope walk makes, and a stack no deeper than the
    deepest internal node; the duplicate clouds and the grid reach the
    tie pass."""
    if kind == "grid":
        lo = hi = _grid(dim)
        qs = np.concatenate([lo[::9], (lo[::11] + np.float32(0.05))])
        qs = qs.astype(np.float32)
    else:
        lo, hi = _cloud(n, dim, seed=3 * n + dim, kind=kind)
        qs = _queries(lo, 12, seed=n)
    tree = _tree(lo, hi)
    stats = {}
    want_d, want_i = TT.bvh_traverse_knn_ref(
        tree.node_lo, tree.node_hi, tree.rope, tree.left_child,
        tree.leaf_perm, torch.from_numpy(qs), k=k, stats=stats)
    d2 = _node_d2(tree, qs)
    max_depth = int(_depths(tree).max())
    tests = passes = 0
    for r in range(len(qs)):
        dd, ii, t, deepest, tie_pass = _nearest_first(tree, d2[r], k)
        tests += t
        passes += tie_pass
        assert torch.equal(TG.sqrt(torch.from_numpy(dd)), want_d[r])
        assert torch.equal(torch.from_numpy(ii), want_i[r])
        assert deepest <= max_depth < TT.STACK_DEPTH
    if tree.num_leaves >= 3000:
        assert tests < stats["visits"]
    if kind in ("dup_points", "grid") and tree.num_leaves > 2 * k:
        assert passes > 0


# ---------------------------------------------------------------------------
# the tree the walk reads
# ---------------------------------------------------------------------------

def _adversarial(name):
    rng = np.random.default_rng(7)
    if name == "all_equal":
        return np.full((4096, 3), 0.25, np.float32)
    if name == "duplicates":          # 2^9 copies of each of 8 points
        return np.repeat(rng.random((8, 3), dtype=np.float32), 512, 0)
    if name == "one_hot_codes":
        # one point per Morton bit: a quantized coordinate 2^j on one axis,
        # so the sorted codes are powers of two (a comb of 63 levels), each
        # repeated 2^5 times (the index bits add levels below)
        pts = []
        for j in range(21):
            for axis in range(3):
                p = np.zeros(3, np.float64)
                p[axis] = (2.0 ** j + 0.5) / 2.0 ** 21
                pts.append(p)
        pts.append(np.ones(3))        # the scene's far corner
        x = np.repeat(np.asarray(pts, np.float32), 32, 0)
        return x
    return rng.random((3000, 3), dtype=np.float32)


@pytest.mark.parametrize("name", ["all_equal", "duplicates", "one_hot_codes",
                                  "uniform"])
def test_internal_depth_within_the_stack_bound(name):
    """Internal nodes lie at depths 0..95 (each one's common prefix of the
    96-bit key is longer than its parent's), so the walk's stack of
    internal nodes, one per depth 1..95, fits STACK_DEPTH entries."""
    x = _adversarial(name)
    tree = _tree(x, x)
    depth = _depths(tree)
    assert (depth >= 0).all() and depth.max() <= TT.STACK_DEPTH - 1
    if name == "one_hot_codes":
        assert depth.max() >= 60       # the comb is deep, as intended
    # the 96-bit key's common prefix over a node's range grows strictly
    # from parent to internal child, and is at least the node's depth
    prefix = _range_prefixes(x, tree)
    assert (prefix >= depth).all() and prefix.max() <= 95
    n = tree.num_leaves
    for side in (tree.left_child.numpy(), tree.right_child.numpy()):
        inner = side < n - 1
        assert (prefix[side[inner]] > prefix[np.nonzero(inner)[0]]).all()


def _range_prefixes(x, tree):
    """(N-1,) common-prefix length of the 96-bit (hi | lo | sorted index)
    keys over each internal node's range, from the build's own keys."""
    c = torch.from_numpy(x)
    codes = M.morton64(c, c.amin(0), c.amax(0))
    n = tree.num_leaves
    codes_s, _ = M.sort_by_morton(codes, torch.arange(n))
    hi, lo, idx = (t.numpy().astype(object) for t in
                   M.combined_delta_key(codes_s, n))
    keys = (hi << 64) | (lo << 32) | idx
    first = tree.range_first.numpy()
    last = tree.range_last.numpy()[:n - 1]
    return np.array([96 - int(keys[f] ^ keys[l]).bit_length()
                     for f, l in zip(first, last)])


@pytest.mark.parametrize("name", ["all_equal", "duplicates", "one_hot_codes",
                                  "uniform"])
def test_left_childs_rope_is_its_right_sibling(name):
    x = _adversarial(name)
    tree = _tree(x, x)
    left, right = tree.left_child.long(), tree.right_child
    assert torch.equal(tree.rope[left], right)
    # the 3-D records carry it: record 2m's w of the left child
    rec = TT.pack_nodes(tree.node_lo, tree.node_hi, tree.rope,
                        tree.left_child, tree.leaf_perm)
    assert torch.equal(rec[left, 3], right)
    assert torch.equal(rec[:len(left), 7], tree.left_child)


def test_knn_order_is_the_leaf_order_only_for_the_indexed_points():
    x = torch.rand((300, 3), generator=torch.Generator().manual_seed(2))
    tree = TL.build(TG.Boxes(x, x))
    assert TT.knn_order(x, x, tree.leaf_perm) is tree.leaf_perm
    assert TT.knn_order(x.clone(), x, tree.leaf_perm) is None
    assert TT.knn_order(x[:10], x, tree.leaf_perm) is None
    assert TT.knn_order(x, None, tree.leaf_perm) is None
    # on the CPU the wrapper takes the twin whatever order it is given
    q = x[:50]
    a = TT.bvh_traverse_knn(tree.node_lo, tree.node_hi, tree.rope,
                            tree.left_child, tree.leaf_perm, q, k=4)
    b = TT.bvh_traverse_knn(tree.node_lo, tree.node_hi, tree.rope,
                            tree.left_child, tree.leaf_perm, q, k=4,
                            records=tree.records,
                            order=tree.leaf_perm[:50].clone())
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# brute force: per-chunk lists merged by key
# ---------------------------------------------------------------------------

def _bf_d2(qs, ps):
    """(Q, N) d2 in the kernel's float order (the twin's expression)."""
    q, p = torch.from_numpy(qs), torch.from_numpy(ps)
    qp = q[:, None, 0] * p[None, :, 0]
    for c in range(1, q.shape[1]):
        qp = TG.fma(q[:, None, c], p[None, :, c], qp)
    d2 = torch.clamp_min((TG.sum_sq(q)[:, None] - 2.0 * qp)
                         + TG.sum_sq(p)[None, :], 0.0)
    return d2.numpy()


def _chunks(n, tail, chunk):
    """The scan's chunks in block-row order (chunk_of in the kernel)."""
    if chunk >= n:
        return [(0, n)], 0
    lo = [(s, min(s + chunk, tail)) for s in range(0, tail, chunk)]
    hi = [(s, min(s + chunk, n)) for s in range(tail, n, chunk)]
    return lo + hi, len(lo)


def _merge_oracle(qs, ps, k, bn, chunk):
    """Each chunk's k smallest by (d2, index), then the lists in chunk
    order into the k smallest by key; the tail is the smallest key of the
    chunks below tail_from; rows without a point take it."""
    n = ps.shape[0]
    tail_at = TB.tail_from(n, bn)
    chunks, s_lo = _chunks(n, tail_at, chunk)
    assert len(chunks) == TB.splits(n, tail_at, chunk)
    d2 = _bf_d2(qs, ps)
    idx = np.arange(n)
    out_d = np.full((len(qs), k), INF, np.float32)
    out_i = np.full((len(qs), k), -1, np.int32)
    for r in range(len(qs)):
        best, tail = [], -1
        for s, (c0, c1) in enumerate(chunks):
            if s == s_lo and len(chunks) > 1:
                tail = best[0][1] if best else -1
            ok = d2[r, c0:c1] < np.inf
            dd, ii = d2[r, c0:c1][ok], idx[c0:c1][ok]
            order = np.lexsort((ii, dd))[:k]
            part = list(zip(dd[order], ii[order]))
            for key in part:              # ascending: stop at the first out
                if len(best) == k and not key < best[-1]:
                    break
                best.append(key)
                best.sort()
                del best[k:]
        if len(chunks) == 1:
            below = [(d, i) for d, i in zip(d2[r, :tail_at], idx[:tail_at])
                     if d < np.inf]
            tail = min(below)[1] if below else -1
        out_d[r, :len(best)] = [b[0] for b in best]
        out_i[r, :len(best)] = [b[1] for b in best]
        out_i[r, len(best):] = tail
    return TG.sqrt(torch.from_numpy(out_d)), torch.from_numpy(out_i)


# (n, bn, chunk, splits): S = 1, 2, 7 and 32 chunks, tail_from inside a
# chunk and at a chunk edge, one and several panels
BF_SPLITS = [(300, 512, 512, 1), (300, 128, 256, 2), (700, 512, 103, 7),
             (2000, 64, 64, 32), (1000, 512, 256, 4), (300, 128, 64, 5)]


@pytest.mark.parametrize("k", [1, 10, 33, 256])
@pytest.mark.parametrize("n,bn,chunk,want_splits", BF_SPLITS)
def test_bruteforce_twin_is_a_chunk_merge_by_key(n, bn, chunk, want_splits,
                                                  k):
    assert TB.splits(n, TB.tail_from(n, bn), chunk) == want_splits
    rng = np.random.default_rng(n + k)
    ps = rng.random((n, 3), dtype=np.float32)
    ps[1::3] = ps[::3][:ps[1::3].shape[0]]         # duplicate points: ties
    qs = np.concatenate([ps[:6], rng.random((6, 3), dtype=np.float32)])
    qs[0, 1] = np.nan                               # a row with no point
    got = TB.bruteforce_knn_ref(torch.from_numpy(qs), torch.from_numpy(ps),
                                k, bn=bn)
    want = _merge_oracle(qs, ps, k, bn, chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bruteforce_tail_is_the_nearest_point_below_the_last_panel():
    """k > N over one panel and over several: the rows past the points hold
    (inf, -1) for one panel, else the nearest point below tail_from."""
    rng = np.random.default_rng(5)
    qs = torch.from_numpy(rng.random((20, 3), dtype=np.float32))
    for n, bn in ((100, 512), (300, 128), (300, 64)):
        ps = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
        d, i = TB.bruteforce_knn_ref(qs, ps, 256, bn=bn)
        start = TB.tail_from(n, bn)
        below = (torch.full((20,), -1, dtype=torch.int32) if start == 0
                 else TB.bruteforce_knn_ref(qs, ps[:start], 1)[1][:, 0])
        assert bool(torch.isinf(d[:, n:]).all())
        assert bool((i[:, n:] == below[:, None]).all())


def test_plan_fills_the_card_and_bounds_the_scratch():
    """The main shape gets about BLOCKS_PER_SM blocks an SM; chunks are
    tile multiples of at least MIN_POINTS_PER_ENTRY * k points; scratch
    stays in bounds."""
    for q, n, k in ((1 << 13, 1 << 20, 10), (1024, 1 << 16, 256),
                    (1 << 13, 1 << 20, 256), (1024, 32768, 8), (1, 1, 1)):
        tail = TB.tail_from(n, 512)
        chunk = TB.plan(q, n, k, tail, sms=132)
        s = TB.splits(n, tail, chunk)
        assert chunk % TB.TILE == 0
        assert chunk >= TB.MIN_POINTS_PER_ENTRY * k
        assert s == 1 or q * s * k * 8 <= TB.SCRATCH_BYTES
    tail = TB.tail_from(1 << 20, 512)
    s = TB.splits(1 << 20, tail, TB.plan(1 << 13, 1 << 20, 10, tail, 132))
    blocks = -(-(1 << 13) // TB.queries_per_block(10)) * s
    assert TB.BLOCKS_PER_SM * 132 <= blocks <= 1.1 * TB.BLOCKS_PER_SM * 132


# ---------------------------------------------------------------------------
# the heap of the large k buckets
# ---------------------------------------------------------------------------

class _Heap:
    """knn_list.cuh's KeyHeap, transcribed."""

    def __init__(self, k):
        self.d = [INF] * k
        self.p = [-1] * k
        self.n = k
        self.lo = (INF, -1)

    @staticmethod
    def less(a, pa, b, pb):
        return a < b or (a == b and pa < pb)

    def admits(self, d2, pos):
        return self.less(d2, pos, self.d[0], self.p[0])

    def sift(self, d2, pos, m):
        j = 0
        while True:
            c = 2 * j + 1
            if c >= m:
                break
            if c + 1 < m and self.less(self.d[c], self.p[c], self.d[c + 1],
                                       self.p[c + 1]):
                c += 1
            if not self.less(d2, pos, self.d[c], self.p[c]):
                break
            self.d[j], self.p[j] = self.d[c], self.p[c]
            j = c
        self.d[j], self.p[j] = d2, pos

    def insert(self, d2, pos):
        if self.n == 1 or self.less(d2, pos, *self.lo):
            self.lo = (d2, pos)
        self.sift(d2, pos, self.n)

    def finish(self):
        for m in range(self.n - 1, 0, -1):
            td, tp = self.d[m], self.p[m]
            self.d[m], self.p[m] = self.d[0], self.p[0]
            self.sift(td, tp, m)


@pytest.mark.parametrize("k", [1, 2, 7, 33, 256])
def test_heap_keeps_the_k_smallest_keys(k):
    rng = np.random.default_rng(k)
    d = rng.integers(0, 40, 600).astype(np.float32)   # many equal d2
    d[::11] = np.inf
    pos = rng.permutation(600)                          # any visit order
    h = _Heap(k)
    lowest = (INF, -1)
    for a, p in zip(d, pos):
        if h.admits(a, p):
            h.insert(a, p)
        if a < np.inf and (a, p) < lowest:
            lowest = (a, p)
        assert h.lo == lowest
    h.finish()
    keys = sorted((x, y) for x, y in zip(d, pos) if x < np.inf)[:k]
    keys += [(INF, -1)] * (k - len(keys))
    assert list(zip(h.d, h.p)) == keys
