"""The ray kNN walk (``RayNearest``, ``cast_nearest``): the port's twin
and its route through ``BVH.query`` against the JAX reference on the CPU,
and the CUDA kernel against the twin on the card (tests marked ``cuda``).

The reference answers ``RayNearest`` with its compiled k-nearest walk
(``repro.core.traversal.traverse_knn``). The port routes the batch to
``kernels.bvh_traverse.bvh_traverse_ray_knn``, whose CPU twin is the same
walk (``core.traversal.knn_walk``) and whose kernel walks, one ray a
thread, the twin's node sequence over Spheres and Triangles and nearest
first over Points and Boxes (transcribed here). Everything is compared bit for bit (tolerance
0), t and indices, ties and the (inf, -1) padding included, on seeded
scenes built to break a careless port:

  * duplicate triangles and duplicate points (ties at the k-th t);
  * origins inside overlapping boxes (every box around the origin enters
    at t = 0) and inside overlapping spheres (node keys at 0, leaf keys
    at the exit root);
  * zero direction components, and rays that miss everything.

The JAX package is imported inside the CPU tests only, so that the file
collects on a machine without JAX, where ``-m cuda`` runs its card
cases. The reference's jitted walks round their last Q mod 8 lanes with
other scalar code (``geometry.ray_sphere``), so every batch holds a
multiple of 8 rays.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import BVH, EngineConfig, ExecutionPolicy, QueryEngine
from repro_torch import convert, raytracing
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.kernels import bvh_traverse as TT

CPU = "cpu"
POLICY = ExecutionPolicy(device=CPU)
KINDS = ["points", "boxes", "spheres", "triangles"]
N, Q = 192, 64
TREE = ("node_lo", "node_hi", "rope", "left_child", "leaf_perm")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def value_arrays(kind, n, rng):
    """Seeded values of `kind` with the scene's traps: duplicates (points,
    triangles), heavy overlap (boxes, spheres)."""
    if kind == "points":
        base = rng.integers(0, 9, (max(n // 3, 1), 3)) / 8.0
        return [base[rng.integers(0, base.shape[0], n)]]
    if kind == "boxes":
        lo = rng.uniform(0.2, 0.6, (n, 3))
        return [lo, lo + rng.uniform(0.05, 0.4, (n, 3))]
    if kind == "spheres":
        return [rng.uniform(0.2, 0.8, (n, 3)), rng.uniform(0.05, 0.25, n)]
    m = max(n // 3, 1)
    a = rng.uniform(0, 1, (m, 3))
    b = a + rng.uniform(-0.2, 0.2, (m, 3))
    c = a + rng.uniform(-0.2, 0.2, (m, 3))
    pick = np.concatenate([np.arange(m), rng.integers(0, m, n - m)])
    rng.shuffle(pick)
    return [a[pick], b[pick], c[pick]]


def ray_arrays(kind, varr, q, rng):
    """(origin, direction) (q, 3): a quarter of the origins inside the
    values (on a point, in the boxes' common core, at a sphere's centre, on
    a triangle's vertex a), a third of the rays aimed at a value, an
    eighth with a zero direction component, and an eighth outside the
    scene pointing away from it (no hit)."""
    o = rng.uniform(0, 1, (q, 3))
    d = rng.normal(size=(q, 3))
    j = rng.integers(0, len(varr[0]), q)
    inside = np.arange(q) % 4 == 1
    if kind == "points":
        o[::2] = rng.integers(0, 9, (len(o[::2]), 3)) / 8.0
        d[::2] = np.eye(3)[rng.integers(0, 3, len(o[::2]))]
        o[inside] = varr[0][j[inside]]
    elif kind == "boxes":
        o[inside] = rng.uniform(0.55, 0.6, (int(inside.sum()), 3))
    elif kind == "spheres":
        o[inside] = varr[0][j[inside]]
    else:
        o[inside] = varr[0][j[inside]]
    aim = np.arange(q) % 3 == 0
    target = varr[0][j] + (0.01 if kind == "points" else 0.0)
    d = np.where(aim[:, None] & ~inside[:, None], target - o, d)
    d[3::8, rng.integers(0, 3)] = 0.0
    away = np.arange(q) % 8 == 6
    o[away] = 5.0 + rng.uniform(0, 1, (int(away.sum()), 3))
    d[away] = np.abs(d[away]) + 0.1
    return [o, d]


@functools.lru_cache(maxsize=None)
def scene(kind, n=N, q=Q, seed=0):
    """(value arrays, ray arrays) as float32 numpy."""
    rng = np.random.default_rng(seed + 10 * KINDS.index(kind))
    varr = value_arrays(kind, n, rng)
    rarr = ray_arrays(kind, varr, q, rng)
    f32 = lambda xs: [np.asarray(x, np.float32) for x in xs]   # noqa: E731
    return f32(varr), f32(rarr)


def port(kind, n=N, q=Q, dev=CPU):
    varr, rarr = scene(kind, n, q)
    return (convert.geometry_from_numpy(kind, varr, dev),
            convert.geometry_from_numpy("rays", rarr, dev))


def reference_cast_nearest(kind, k, n=N, q=Q):
    """The JAX reference's cast_nearest on the same arrays (numpy)."""
    import jax.numpy as jnp
    from repro.core import BVH as JBVH
    from repro.core import geometry as JG
    from repro.core import raytracing as JRT
    cls = {"points": JG.Points, "boxes": JG.Boxes, "spheres": JG.Spheres,
           "triangles": JG.Triangles}[kind]
    varr, rarr = scene(kind, n, q)
    jv = cls(*(jnp.asarray(a) for a in varr))
    jr = JG.Rays(*(jnp.asarray(a) for a in rarr))
    t, i = JRT.cast_nearest(JBVH(jv), jr, k)
    return np.asarray(t), np.asarray(i)


def assert_same(got, want):
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _scene_traps(kind, t, i, k):
    """The scene reaches what it was built for: hits, misses, t = 0 entries
    where origins lie inside values, and ties in t (duplicates, t = 0)."""
    t, i = t.numpy(), i.numpy()
    assert np.isfinite(t[:, 0]).sum() >= Q // 4
    assert (~np.isfinite(t[:, 0])).sum() >= Q // 8
    assert np.array_equal(np.isinf(t), i == -1)
    if kind in ("points", "boxes"):
        assert (t[:, 0] == 0).sum() >= Q // 8
    if kind != "spheres":
        assert (t[:, 1:] == t[:, :-1])[np.isfinite(t[:, 1:])].any()


# ---------------------------------------------------------------------------
# CPU: the twin and the route against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_twin_and_route_match_reference(kind, k):
    """bvh_traverse_ray_knn's twin and BVH.query(RayNearest) (the kernel
    route, which takes the twin on the CPU) equal the reference's
    cast_nearest bit for bit; the loop route gives the same."""
    values, rays = port(kind)
    want = reference_cast_nearest(kind, k)
    engine = QueryEngine()
    index = BVH(values, policy=POLICY.override(engine=engine))
    assert engine.route_knn(index, TP.RayNearest(rays, k)) == "kernel"
    t = index.tree
    twin = TT.bvh_traverse_ray_knn_ref(*(getattr(t, f) for f in TREE),
                                       values, rays, k=k)
    assert_same(twin, want)
    before = TT.bvh_traverse_ray_knn.launches
    got = raytracing.cast_nearest(index, rays, k)
    assert TT.bvh_traverse_ray_knn.launches == before   # the CPU twin ran
    assert_same(got, want)
    loop = BVH(values, policy=POLICY.override(
        engine=QueryEngine(EngineConfig(force="loop"))))
    assert_same(raytracing.cast_nearest(loop, rays, k), want)
    if k == 4:
        _scene_traps(kind, *got, k)


@pytest.mark.parametrize("kind", KINDS)
def test_k_above_n_pads_like_reference(kind):
    """k > N: every hit, then (inf, -1), as the reference gives them."""
    n, k = 24, 40
    values, rays = port(kind, n=n)
    want = reference_cast_nearest(kind, k, n=n)
    index = BVH(values, policy=POLICY)
    got = raytracing.cast_nearest(index, rays, k)
    assert_same(got, want)
    assert bool(torch.isinf(got[0][:, n:]).all() & (got[1][:, n:] == -1).all())


def test_wrapper_refuses_what_the_kernel_cannot_take():
    values, rays = port("boxes")
    t = BVH(values, policy=POLICY).tree
    tree = [getattr(t, f) for f in TREE]
    with pytest.raises(ValueError, match="k must be"):
        TT.bvh_traverse_ray_knn(*tree, values, rays, k=0)
    with pytest.raises(ValueError, match="rays against"):
        TT.bvh_traverse_ray_knn(*tree, values, TG.Points(rays.origin), k=1)
    flat = TG.Rays(rays.origin[:, :2], rays.direction[:, :2])
    with pytest.raises(ValueError, match="rays against"):
        TT.bvh_traverse_ray_knn(*tree, values, flat, k=1)


def test_route_takes_the_loop_where_the_kernel_cannot():
    """k above KNN_MAX_K, or a custom indexable getter, walk the loop;
    force="loop" pins it."""
    values, rays = port("triangles")
    engine = QueryEngine()
    index = BVH(values, policy=POLICY.override(engine=engine))
    big = TP.RayNearest(rays, TT.KNN_MAX_K + 1)
    assert engine.route_knn(index, big) == "loop"
    loop = QueryEngine(EngineConfig(force="loop"))
    assert loop.route_knn(index, TP.RayNearest(rays, 1)) == "loop"
    custom = BVH(values, indexable_getter=lambda v: TG.to_boxes(v),
                 policy=POLICY.override(engine=engine))
    assert engine.route_knn(custom, TP.RayNearest(rays, 1)) == "loop"


# ---------------------------------------------------------------------------
# the kernel's two walks, transcribed (CPU)
# ---------------------------------------------------------------------------

def node_keys(tree, rays):
    """(R, 2N-1) float32 slab-entry t of every node box (+inf on a miss):
    the walks' node keys, and a Points or Boxes leaf's hit t."""
    _, t = TG.ray_box(rays.origin[:, None, :], rays.direction[:, None, :],
                      tree.node_lo[None], tree.node_hi[None])
    return t.numpy()


@pytest.mark.parametrize("k", [1, 2, 4, 33])
@pytest.mark.parametrize("kind", ["points", "boxes"])
def test_nearest_first_walk_gives_the_twins_lists(kind, k):
    """csrc/ray_knn.cu's walk over Points and Boxes (nearest first with a
    stack, then its tie pass), transcribed with the slab-entry t as the key
    (test_torch_knn_keys' transcription of the point kNN walk, the same
    code): the twin's lists bit for bit on the tie scenes, where origins on
    points and inside overlapping boxes send rays through the tie pass."""
    from test_torch_knn_keys import _nearest_first
    values, rays = port(kind)
    tree = BVH(values, policy=POLICY).tree
    want_t, want_i = TT.bvh_traverse_ray_knn_ref(
        *(getattr(tree, f) for f in TREE), values, rays, k=k)
    keys = node_keys(tree, rays)
    passes = 0
    for r in range(Q):
        tt, ii, _, deepest, tie_pass = _nearest_first(tree, keys[r], k)
        assert torch.equal(torch.from_numpy(tt), want_t[r])
        assert torch.equal(torch.from_numpy(ii), want_i[r])
        assert deepest < TT.STACK_DEPTH
        passes += tie_pass
    if k <= 4:          # at k = 33 few rays hold 33 hits: no k-th t to tie
        assert passes > 0


def test_triangle_hit_can_fall_below_its_own_box_entry():
    """Why Spheres and Triangles keep the rope walk: the premise of the
    nearest-first walk, that no node's key exceeds the hit t of a leaf
    below it, fails for them. Rays aimed at flat (z = const) triangles: the
    Moller-Trumbore t (the walk's fused order) rounds below the slab-entry
    t of the triangle's own box on a good share of the hits."""
    rng = np.random.default_rng(7)
    m = 4096
    a = rng.uniform(0, 1, (m, 3))
    flat = np.c_[rng.uniform(-0.1, 0.1, (m, 2)), np.zeros(m)]
    b = a + flat
    c = a + np.c_[rng.uniform(-0.1, 0.1, (m, 2)), np.zeros(m)]
    o = rng.uniform(0, 1, (m, 3))
    w = rng.dirichlet([1, 1, 1], m)
    d = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c - o
    a, b, c, o, d = (torch.from_numpy(x.astype(np.float32))
                     for x in (a, b, c, o, d))
    tri = TG.Triangles(a, b, c)
    box = TG.to_boxes(tri)
    hit, t_hit = TG.ray_triangle(o, d, a, b, c, fused=True)
    _, t_box = TG.ray_box(o, d, box.lo, box.hi)
    below = hit & (t_hit < t_box)
    assert int(hit.sum()) > m // 2 and int(below.sum()) > m // 20


# ---------------------------------------------------------------------------
# on the card (python -m pytest -m cuda tests/test_torch_ray_knn.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _on_card(kind, dev, n=N, q=Q):
    values, rays = port(kind, n, q, dev)
    t = BVH(values, policy=ExecutionPolicy(device=dev)).tree
    return [getattr(t, f) for f in TREE], t, values, rays


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 8, 10, 32, 33, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_twin_on_the_card(cuda_device, kind, k):
    """The kernel (node and value records, every list bucket) against its
    twin on each scene."""
    tree, _, values, rays = _on_card(kind, cuda_device)
    want = TT.bvh_traverse_ray_knn_ref(*tree, values, rays, k=k)
    before = TT.bvh_traverse_ray_knn.launches
    got = TT.bvh_traverse_ray_knn(*tree, values, rays, k=k)
    torch.cuda.synchronize()
    assert TT.bvh_traverse_ray_knn.launches == before + 1
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("dim", [2, 5])
def test_flat_instance_matches_twin_on_the_card(cuda_device, kind, dim):
    """Other dims: the flat node arrays, spheres gathered by index."""
    rng = np.random.default_rng(dim)
    n, q = 300, 96
    c = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    arrays = {"points": [c], "boxes": [c, c + 0.1],
              "spheres": [c, np.full(n, 0.08, np.float32)]}[kind]
    values = convert.geometry_from_numpy(kind, arrays, cuda_device)
    o = rng.uniform(0, 1, (q, dim)).astype(np.float32)
    d = rng.normal(size=(q, dim)).astype(np.float32)
    d[::5, 0] = 0.0
    rays = TG.Rays(torch.from_numpy(o), torch.from_numpy(d)).to(cuda_device)
    t = BVH(values, policy=ExecutionPolicy(device=cuda_device)).tree
    tree = [getattr(t, f) for f in TREE]
    for k in (1, 4, 40):
        want = TT.bvh_traverse_ray_knn_ref(*tree, values, rays, k=k)
        assert_same(TT.bvh_traverse_ray_knn(*tree, values, rays, k=k), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cast_nearest_on_the_card_takes_the_kernel(cuda_device, kind):
    """cast_nearest on a card index: the kernel route, one launch, the
    index's kept records, the twin's lists (k > N too)."""
    values, rays = port(kind, dev=cuda_device)
    engine = QueryEngine()
    index = BVH(values, policy=ExecutionPolicy(device=cuda_device,
                                               engine=engine))
    t = index.tree
    for k in (4, N + 8):
        before = TT.bvh_traverse_ray_knn.launches
        got = raytracing.cast_nearest(index, rays, k)
        torch.cuda.synchronize()
        assert TT.bvh_traverse_ray_knn.launches == before + 1
        want = TT.bvh_traverse_ray_knn_ref(*(getattr(t, f) for f in TREE),
                                           values, rays, k=k)
        assert_same(got, want)
    assert (index.value_records is None) == (kind in ("points", "boxes"))


# ---------------------------------------------------------------------------
# the value records of the 3-D ray walks (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_value_records_read_back(kind):
    """pack_values, read back, gives each leaf's value gathered through
    leaf_perm (and a triangle's original index); Points and Boxes, and
    other dims, have none; BVH.value_records keeps the same records."""
    values, _ = port(kind)
    index = BVH(values, policy=POLICY)
    perm = index.tree.leaf_perm.to(torch.int64)
    rec = TT.pack_values(values, index.tree.leaf_perm)
    if kind in ("points", "boxes"):
        assert rec is None and index.value_records is None
        return
    assert torch.equal(index.value_records, rec)
    f = rec.view(torch.float32)
    if kind == "spheres":
        assert rec.shape == (N, 4)
        assert torch.equal(f[:, :3], values.center[perm])
        assert torch.equal(f[:, 3], values.radius[perm])
    else:
        assert rec.shape == (N, 12)
        for j, v in enumerate((values.a, values.b, values.c)):
            assert torch.equal(f[:, 4 * j:4 * j + 3], v[perm])
        assert torch.equal(rec[:, 3], index.tree.leaf_perm)
        assert not bool(rec[:, 7].any() | rec[:, 11].any())
    c = torch.rand((10, 2))
    assert TT.pack_values(TG.Spheres(c, c[:, 0]),
                          torch.arange(10, dtype=torch.int32)) is None

