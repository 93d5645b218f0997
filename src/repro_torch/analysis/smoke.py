"""--sanitize-smoke: every kernel wrapper armed with REPRO_SANITIZE on a
small scene, held to an oracle; the port's ``repro.analysis.smoke``.

The static passes prove properties of the source; this lane proves the
wrappers' runtime contracts. It sets REPRO_SANITIZE for the run (and
restores it after), so every :mod:`repro_torch.kernels.sanitize`
assertion is live (and the Karras wrapper holds its kernel to its twin),
and drives each wrapper on a small scene: on CPU tensors the wrappers run their plain twins, on the card
their CUDA kernels. Each result is held to an oracle that shares no code
with the walk: numpy all-pairs distances and counts, a brute-force index,
the twins of ``kernels.ref``.

  * the build (Morton key, Karras ranges, the tail) and a refit, through
    the spatial, kNN and exclusion walks that read the trees: counts and
    distances against the numpy oracle;
  * the callback kernel: ``counting`` against the all-pairs counts;
  * the fine kNN walk (triangles; on the card its rope walk too) and the
    ray kNN walk: distances against ``BruteForce``;
  * ``ops.bruteforce_knn`` (k > N too) against the numpy oracle, and
    ``ops.morton64``, ``ops.ray_box_nearest`` and ``ops.flash_attention``
    against ``kernels.ref``.

Seconds on the CPU (N = 2000, Q = 256); any contract violation or
disagreement raises AssertionError, which the CLI maps to exit code 1.
``launches.strict`` runs it on the card to launch every C entry once.
"""
from __future__ import annotations

import os

__all__ = ["run"]


def _expect(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"sanitize smoke: {what}")


def _close(a, b, rtol=1e-4, atol=1e-5) -> bool:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.allclose(a, b, rtol=rtol,
                                                   atol=atol))


def run(n: int = 2000, q: int = 256, seed: int = 0, device: str = "cpu",
        echo=print) -> int:
    prev = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        return _run(n, q, seed, device, echo)
    finally:
        if prev is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = prev


def _run(n, q, seed, device, echo) -> int:
    import numpy as np
    import torch

    from ..core import callbacks as CB
    from ..core import geometry as G
    from ..core import lbvh
    from ..core import predicates as P
    from ..core.brute_force import BruteForce
    from ..core.bvh import BVH
    from ..core.engine import EngineConfig, QueryEngine
    from ..core.index import ExecutionPolicy
    from ..kernels import bvh_traverse as BT
    from ..kernels import ops, ref, sanitize

    _expect(sanitize.enabled(), "REPRO_SANITIZE did not arm")
    dev = torch.device(device)
    policy = ExecutionPolicy(device=dev, engine=QueryEngine(
        EngineConfig(force="kernel")))

    def host(t):
        return t.detach().cpu().numpy()

    rng = np.random.default_rng(seed)
    pts_np = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    qp_np = rng.uniform(0, 1, (q, 3)).astype(np.float32)
    pts, qp = torch.from_numpy(pts_np).to(dev), torch.from_numpy(qp_np).to(dev)
    dist = np.sqrt(((qp_np[:, None, :].astype(np.float64)
                     - pts_np[None, :, :]) ** 2).sum(-1))        # (q, n)
    k = 8

    # --- the build, spatial fill, kNN, exclusion, callback, refit ----------
    index = BVH(G.Points(pts), policy=policy)
    r = 0.1
    spheres = P.intersects(G.Spheres(qp, torch.full((q,), r, device=dev)))
    res = index.query(spheres)
    want_cnt = (dist <= r).sum(-1)
    _expect(np.array_equal(np.diff(host(res.offsets)), want_cnt),
            "the spatial walk's counts differ from the all-pairs oracle")
    echo(f"  spatial ok   (n={n}, q={q}, mean count "
         f"{float(want_cnt.mean()):.1f})")

    res = index.query(P.nearest(G.Points(qp), k=k))
    want_d = np.sort(dist, axis=-1)[:, :k]
    _expect(_close(host(res.distances), want_d),
            "the kNN walk's distances differ from the oracle")
    echo(f"  knn ok       (k={k})")

    labels_q = torch.from_numpy((np.arange(q) % 4).astype(np.int32)).to(dev)
    labels_v = torch.from_numpy((np.arange(n) % 4).astype(np.int32)).to(dev)
    res = index.query(P.nearest(G.Points(qp), k=k,
                                exclude=(labels_q, labels_v)))
    masked = np.where((np.arange(q) % 4)[:, None] == (np.arange(n) % 4)[None],
                      np.inf, dist)
    _expect(_close(host(res.distances), np.sort(masked, -1)[:, :k]),
            "the exclusion walk's distances differ from the oracle")
    echo("  exclude ok   (labels mod 4)")

    got = index.query(spheres, callback=CB.counting())
    _expect(np.array_equal(host(got), want_cnt),
            "the callback kernel's counts differ from the all-pairs oracle")
    echo("  callback ok  (counting)")

    moved_np = pts_np + np.float32(0.01)
    moved = torch.from_numpy(moved_np).to(dev)
    tree = lbvh.refit(index.tree, G.Boxes(moved, moved))
    res = BVH.from_tree(G.Points(moved), tree, policy=policy).query(
        P.nearest(G.Points(qp), k=k))
    d_moved = np.sqrt(((qp_np[:, None, :].astype(np.float64)
                        - moved_np[None, :, :]) ** 2).sum(-1))
    _expect(_close(host(res.distances), np.sort(d_moved, -1)[:, :k]),
            "the refitted tree's kNN differs from the oracle")
    echo("  refit ok     (kNN over the refitted tree)")

    # --- fine and ray kNN walks against brute force -------------------------
    m = 300
    a = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    b = a + rng.uniform(-0.02, 0.02, (m, 3)).astype(np.float32)
    c = a + rng.uniform(-0.02, 0.02, (m, 3)).astype(np.float32)
    tri = G.Triangles(*(torch.from_numpy(x).to(dev) for x in (a, b, c)))
    tris = BVH(tri, policy=policy)
    brute = BruteForce(tri, policy=policy)
    near = P.nearest(G.Points(qp[:64]), k=4)
    fine = tris.query(near)
    _expect(_close(host(fine.distances), host(brute.query(near).distances)),
            "the fine kNN walk differs from brute force")
    if dev.type == "cuda":
        t = tris.tree
        rope_d, rope_i = BT.bvh_traverse_fine_knn_rope(
            t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm, tri,
            G.Points(qp[:64]), k=4)
        _expect(torch.equal(rope_d, fine.distances)
                and torch.equal(rope_i, fine.indices),
                "the fine kNN walk differs from its rope walk")
    echo("  fine knn ok  (triangles, k=4)")

    dirs = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)).to(dev)
    rays = P.RayNearest(G.Rays(qp[:64] - dirs, dirs), 2)
    boxes = G.Boxes(pts[:500] - 0.01, pts[:500] + 0.01)
    got = BVH(boxes, policy=policy).query(rays)
    want = BruteForce(boxes, policy=policy).query(rays)
    _expect(_close(host(got.distances), host(want.distances)),
            "the ray kNN walk differs from brute force")
    echo("  ray knn ok   (boxes, k=2)")

    # --- the stand-alone ops ------------------------------------------------
    d_b, _ = ops.bruteforce_knn(qp, pts, k)
    _expect(_close(host(d_b), want_d),
            "ops.bruteforce_knn distances differ from the oracle")
    d_t, _ = ops.bruteforce_knn(qp, pts[:5], k)        # k > N: the tail
    _expect(_close(host(d_t)[:, :5], np.sort(dist[:, :5], -1)),
            "ops.bruteforce_knn with k > N differs from the oracle")
    hi, lo = ops.morton64(pts)
    w_hi, w_lo = ref.morton64_ref(pts, pts.amin(0), pts.amax(0))
    _expect(torch.equal(hi, w_hi) and torch.equal(lo, w_lo),
            "ops.morton64 differs from its reference")
    t_r, i_r = ops.ray_box_nearest(qp[:64] - dirs, dirs, boxes.lo, boxes.hi)
    w_t, w_i = ref.ray_box_nearest_ref(qp[:64] - dirs, dirs, boxes.lo,
                                       boxes.hi)
    _expect(_close(host(t_r), host(w_t)) and torch.equal(i_r, w_i),
            "ops.ray_box_nearest differs from its reference")
    gen = torch.Generator().manual_seed(seed)
    qkv = [torch.randn((1, 2, 64, 64), generator=gen).to(dev)
           for _ in range(3)]
    out = ops.flash_attention(*qkv, causal=True)
    _expect(_close(host(out), host(ref.attention_ref(*qkv, causal=True)),
                   rtol=1e-4, atol=1e-4),
            "ops.flash_attention differs from attention_ref")
    echo(f"  ops ok       (bruteforce_knn, morton64, ray_box_nearest, "
         f"flash_attention)")

    echo(f"sanitize smoke: all kernel contracts held on {dev}")
    return 0
