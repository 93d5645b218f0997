"""The port's DistributedTree against the reference's, on the CPU.

One reference subprocess (``conftest.run_subprocess``: R fake host
devices, a mesh of R) and one port world (``run_world``: R processes in
a gloo group, rank r holding block r of the values and of every
predicate batch) run the same seeded scenarios at R = 4, 3 and 1 and
write their results; the tests below compare them, one scenario each.
The port's ranks save their own queries' results, which are
concatenated in rank order (CSR offsets shifted) before the comparison.

Parity strength: counts, callback states, shipped values (signed zeros
included) and the scene bounds bit-identical; CSR fill set-equal per
query; kNN distances bit-identical and indices equal except among
distance ties (``assert_knn_equal``); refusals and errors of the same
exception type on every rank.
"""
from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import pytest

from conftest import run_subprocess
from test_torch_parity import (assert_knn_equal, merge_ranks, run_world,
                               world_results)

#: R -> (values a rank, queries a rank, the scenario groups run): every
#: group at R = 4; at R = 1 the single-process conformance cases; at R = 3
#: the fold order and the unequal blocks again
WORLDS = {4: (50, 8, ("core", "conf", "cb", "refuse", "geo")),
          3: (50, 6, ("core", "cb")),
          1: (50, 8, ("core", "conf"))}

DATA = """
R_, NL, QL, PARTS = {ranks}, {nl}, {ql}, {parts!r}
N, Q = R_ * NL, R_ * QL
KS = (1, 5, NL + 3)
rng = np.random.default_rng(1)
PTS = rng.uniform(0, 1, (N, 3)).astype(np.float32)
PTS[1, 0] = 0.0                       # +0 on rank 0, -0 on the last rank:
ZROW = (R_ - 1) * NL + 1              # the scene box's min x is -0
PTS[ZROW, 0] = -0.0
QP = np.random.default_rng(2).uniform(0, 1, (Q, 3)).astype(np.float32)
QP[0] = PTS[ZROW]                     # query 0 matches the -0 point
BOX_LO, BOX_HI = PTS - np.float32(0.03), PTS + np.float32(0.03)
TRI_B = (PTS + rng.uniform(-0.05, 0.05, PTS.shape)).astype(np.float32)
TRI_C = (PTS + rng.uniform(-0.05, 0.05, PTS.shape)).astype(np.float32)
r3 = np.random.default_rng(3)
RAY_O = r3.uniform(0, 1, (Q, 3)).astype(np.float32)
RAY_D = r3.normal(size=(Q, 3)).astype(np.float32)
AX_O = PTS[r3.integers(0, N, Q)].copy()   # axis rays through points
AX_O[:, 0] -= 1.0
AX_D = np.tile(np.float32([1, 0, 0]), (Q, 1))
PAYLOAD = np.arange(Q, dtype=np.float32) * 10 + 1
"""

REF = """
import jax, jax.numpy as jnp, numpy as np, dataclasses
from repro.compat import AxisType, make_mesh
from repro.core import geometry as G, predicates as P, callbacks as CB
from repro.core.distributed import DistributedTree
""" + DATA + """
mesh = make_mesh((R_,), ("data",), axis_types=(AxisType.Auto,))
j = jnp.asarray
out = {{}}

def err(key, fn):
    try:
        fn()
        out[key] = np.array("none")
    except Exception as e:
        out[key] = np.array(type(e).__name__)

def sph(r, q=QP):
    return P.intersects(G.Spheres(j(q), jnp.full((len(q),), r, jnp.float32)))

def csr(key, res):
    out[key + "_off"] = np.asarray(res.offsets)
    out[key + "_idx"] = np.asarray(res.indices)

def knn(key, res):
    out[key + "_d"] = np.asarray(res.distances)
    out[key + "_i"] = np.asarray(res.indices)

dt = DistributedTree(mesh, "data", j(PTS))
for k in KS:
    knn(f"knn{{k}}", dt.query(P.nearest(G.Points(j(QP)), k=k)))
out["count"] = np.asarray(dt.count(sph(0.3)))
csr("csr", dt.query(sph(0.3)))
res = dt.query(sph(0.3), capacity=2)
csr("cap", res)
out["rep_cap_over"] = np.array(res.overflow)
res = dt.query(sph(0.3), policy=dt.policy.override(capacity=2,
                                                   max_doublings=0))
csr("trunc", res)
out["rep_trunc_over"] = np.array(res.overflow)
if "conf" in PARTS:
    knn("rayax", dt.query(P.RayNearest(G.Rays(j(AX_O), j(AX_D)), 1)))
lo, hi = (np.asarray(a) for a in (dt.bounds().lo, dt.bounds().hi))
out["rep_bounds_lo"], out["rep_bounds_hi"] = lo, hi

def maxcb(state, pred, value, index, t):
    return jnp.maximum(state, pred.data), jnp.bool_(False)
out["attach"] = np.asarray(dt.query(
    P.attach_data(sph(0.25), j(PAYLOAD)), callback=(maxcb, jnp.float32(-1)),
    policy=dt.policy.override(combine=jnp.maximum)))
if "cb" in PARTS:
    def mincb(state, pred, value, index, t):
        return jnp.minimum(state, value.coords[0]), jnp.bool_(False)
    out["mincb"] = np.asarray(dt.query(
        sph(0.25), callback=(mincb, jnp.float32(jnp.inf)),
        policy=dt.policy.override(combine=jnp.minimum)))
    out["fsum"] = np.asarray(dt.query(sph(0.4), callback=(CB.sum_payload(
        lambda pred, v: v.coords[0] - v.coords[1]), jnp.float32(0))))
    out["mindist"] = np.asarray(dt.query(
        sph(0.3), callback=CB.min_distance(),
        policy=dt.policy.override(combine=jnp.minimum)))
if "conf" in PARTS:
    out["countcomb"] = np.asarray(DistributedTree(
        mesh, "data", j(PTS), policy=dt.policy.override(combine=jnp.minimum)
    ).count(sph(0.3)))

ship = dt.policy.override(ship_values=True)
out["rep_noship"] = np.array(dt.query(sph(0.2)).values is None)
res = dt.query(sph(0.2), policy=ship)
csr("ship", res)
out["ship_val"] = np.asarray(res.values.coords)
res = dt.query(P.nearest(G.Points(j(QP)), k=3), policy=ship)
knn("shipknn", res)
out["shipknn_val"] = np.asarray(res.values.coords)
res = dt.query(sph(0.2), out=lambda p, v, i, t: v.coords[0] * 2,
               policy=ship)
csr("outs", res)
out["outs_val"] = np.asarray(res.values)

if "conf" in PARTS:
    z = np.zeros((0, 3), np.float32)
    out["rep_q0_knn"] = np.array(dt.query(P.nearest(G.Points(j(z)), k=3)).indices.shape)
    out["rep_q0_off"] = np.asarray(dt.query(sph(0.3, z)).offsets)
    out["rep_q0_count"] = np.array(dt.count(sph(0.3, z)).shape)
    out["rep_q0_cb"] = np.array(dt.query(sph(0.3, z), callback=CB.counting()).shape)
    out["rep_q0_ship"] = np.array(dt.query(sph(0.3, z), policy=ship).values.coords.shape)
if "refuse" in PARTS:
    err("err_ordered", lambda: dt.query(P.RayOrderedIntersect(G.Rays(j(RAY_O), j(RAY_D)))))
    err("err_out", lambda: dt.query(sph(0.2), out=lambda p, v, i, t: i))
    lab = jnp.zeros((Q,), jnp.int32), jnp.zeros((N,), jnp.int32)
    err("err_exclude", lambda: dt.query(P.nearest(G.Points(j(QP)), k=2, exclude=lab)))
    out["after_count"] = np.asarray(dt.count(sph(0.1)))
if "conf" in PARTS:
    err("err_flt_leaves", lambda: DistributedTree.from_local_trees(
        mesh, "data", j(PTS[:N // 2]), dt.trees, dt.top_lo, dt.top_hi))
    short = dataclasses.replace(dt.trees, node_lo=dt.trees.node_lo[:-1],
                                node_hi=dt.trees.node_hi[:-1])
    err("err_flt_nodes", lambda: DistributedTree.from_local_trees(
        mesh, "data", j(PTS), short, dt.top_lo, dt.top_hi))
    err("err_flt_top", lambda: DistributedTree.from_local_trees(
        mesh, "data", j(PTS), dt.trees, dt.top_lo[:, :1], dt.top_hi[:, :1]))
    flt = DistributedTree.from_local_trees(mesh, "data", j(PTS), dt.trees,
                                           dt.top_lo, dt.top_hi)
    knn("flt", flt.query(P.nearest(G.Points(j(QP)), k=3)))
err("err_few", lambda: DistributedTree(mesh, "data", j(PTS[:R_])))
if R_ > 1:
    err("err_unequal", lambda: DistributedTree(mesh, "data", j(PTS[:N - 1])))
    err("err_unequal_q", lambda: dt.count(sph(0.3, QP[:Q - 1])))

if "geo" in PARTS:
    bx = DistributedTree(mesh, "data", G.Boxes(j(BOX_LO), j(BOX_HI)))
    knn("box_knn5", bx.query(P.nearest(G.Points(j(QP)), k=5)))
    out["box_count"] = np.asarray(bx.count(sph(0.1)))
    csr("box_csr", bx.query(sph(0.1)))
    for k in (1, 3):
        knn(f"box_ray{{k}}", bx.query(P.RayNearest(G.Rays(j(RAY_O), j(RAY_D)), k)))
    tri = DistributedTree(mesh, "data", G.Triangles(j(PTS), j(TRI_B), j(TRI_C)))
    for k in (1, 5):
        knn(f"tri_knn{{k}}", tri.query(P.nearest(G.Points(j(QP)), k=k)))
    out["tri_count"] = np.asarray(tri.count(sph(0.1)))
    csr("tri_csr", tri.query(sph(0.1)))
np.savez(OUT, **out)
print("REF OK")
"""

PORT = """
import dataclasses
import repro_torch as rt
from repro_torch.core import geometry as G, predicates as P, callbacks as CB
from repro_torch.core.distributed import DistributedTree
""" + DATA + """
t = torch.from_numpy
blk = slice(RANK * NL, (RANK + 1) * NL)
qb = slice(RANK * QL, (RANK + 1) * QL)
pol = rt.ExecutionPolicy(device="cpu")
out = {{}}

def err(key, fn):
    try:
        fn()
        out[key] = np.array("none")
    except Exception as e:
        out[key] = np.array(type(e).__name__)

def sph(r, q=None):
    q = QP[qb] if q is None else q
    return P.intersects(G.Spheres(t(q), torch.full((len(q),), r)))

def csr(key, res):
    out[key + "_off"] = res.offsets.numpy()
    out[key + "_idx"] = res.indices.numpy()

def knn(key, res):
    out[key + "_d"] = res.distances.numpy()
    out[key + "_i"] = res.indices.numpy()

qpts = G.Points(t(QP[qb]))
dt = DistributedTree(None, t(PTS[blk]), policy=pol)
for k in KS:
    knn(f"knn{{k}}", dt.query(P.nearest(qpts, k=k)))
out["count"] = dt.count(sph(0.3)).numpy()
csr("csr", dt.query(sph(0.3)))
res = dt.query(sph(0.3), capacity=2)
csr("cap", res)
out["rep_cap_over"] = np.array(res.overflow)
res = dt.query(sph(0.3), policy=pol.override(capacity=2, max_doublings=0))
csr("trunc", res)
out["rep_trunc_over"] = np.array(res.overflow)
if "conf" in PARTS:
    knn("rayax", dt.query(P.RayNearest(G.Rays(t(AX_O[qb]), t(AX_D[qb])), 1)))
b = dt.bounds()
out["rep_bounds_lo"], out["rep_bounds_hi"] = b.lo.numpy(), b.hi.numpy()

# G.min_zeros / max_zeros order -0 below +0, as jnp.minimum / maximum
def maxcb(state, pred, value, index, t_):
    return G.max_zeros(state, pred.data), torch.zeros_like(index, dtype=torch.bool)
out["attach"] = dt.query(
    P.attach_data(sph(0.25), t(PAYLOAD[qb])), callback=(maxcb, torch.tensor(-1.0)),
    policy=pol.override(combine=G.max_zeros)).numpy()
if "cb" in PARTS:
    def mincb(state, pred, value, index, t_):
        return G.min_zeros(state, value.coords[:, 0]), torch.zeros_like(index, dtype=torch.bool)
    out["mincb"] = dt.query(sph(0.25), callback=(mincb, torch.tensor(float("inf"))),
                            policy=pol.override(combine=G.min_zeros)).numpy()
    out["fsum"] = dt.query(sph(0.4), callback=(CB.sum_payload(
        lambda pred, v: v.coords[:, 0] - v.coords[:, 1]), torch.tensor(0.0))).numpy()
    out["mindist"] = dt.query(sph(0.3), callback=CB.min_distance(),
                              policy=pol.override(combine=torch.minimum)).numpy()
    # every rank's own partial sums, to show the rank order of the fold matters
    local = rt.BVH(G.Points(t(PTS[blk])), policy=pol)
    out["rank_fsum_part"] = local.query(sph(0.4, QP), callback=(CB.sum_payload(
        lambda pred, v: v.coords[:, 0] - v.coords[:, 1]), torch.tensor(0.0))).numpy()
if "conf" in PARTS:
    out["countcomb"] = DistributedTree(
        None, t(PTS[blk]), policy=pol.override(combine=torch.minimum)
    ).count(sph(0.3)).numpy()

ship = pol.override(ship_values=True)
out["rep_noship"] = np.array(dt.query(sph(0.2)).values is None)
res = dt.query(sph(0.2), policy=ship)
csr("ship", res)
out["ship_val"] = res.values.coords.numpy()
res = dt.query(P.nearest(qpts, k=3), policy=ship)
knn("shipknn", res)
out["shipknn_val"] = res.values.coords.numpy()
res = dt.query(sph(0.2), out=lambda p, v, i, t_: v.coords[:, 0] * 2,
               policy=ship)
csr("outs", res)
out["outs_val"] = res.values.numpy()

if "conf" in PARTS:
    z = np.zeros((0, 3), np.float32)
    out["rep_q0_knn"] = np.array(dt.query(P.nearest(G.Points(t(z)), k=3)).indices.shape)
    out["rep_q0_off"] = dt.query(sph(0.3, z)).offsets.numpy()
    out["rep_q0_count"] = np.array(dt.count(sph(0.3, z)).shape)
    out["rep_q0_cb"] = np.array(dt.query(sph(0.3, z), callback=CB.counting()).shape)
    out["rep_q0_ship"] = np.array(dt.query(sph(0.3, z), policy=ship).values.coords.shape)
if "refuse" in PARTS:
    err("err_ordered", lambda: dt.query(P.RayOrderedIntersect(G.Rays(t(RAY_O[qb]), t(RAY_D[qb])))))
    err("err_out", lambda: dt.query(sph(0.2), out=lambda p, v, i, t_: i))
    lab = (torch.zeros(QL, dtype=torch.int32), torch.zeros(NL, dtype=torch.int32))
    err("err_exclude", lambda: dt.query(P.nearest(qpts, k=2, exclude=lab)))
    out["after_count"] = dt.count(sph(0.1)).numpy()
if "conf" in PARTS:
    err("err_flt_leaves", lambda: DistributedTree.from_local_trees(
        None, t(PTS[blk][:NL // 2]), dt.tree, dt.top_lo, dt.top_hi, policy=pol))
    short = dataclasses.replace(dt.tree, node_lo=dt.tree.node_lo[:-1],
                                node_hi=dt.tree.node_hi[:-1])
    err("err_flt_nodes", lambda: DistributedTree.from_local_trees(
        None, t(PTS[blk]), short, dt.top_lo, dt.top_hi, policy=pol))
    err("err_flt_top", lambda: DistributedTree.from_local_trees(
        None, t(PTS[blk]), dt.tree, dt.top_lo[:, :1], dt.top_hi[:, :1],
        policy=pol))
    flt = DistributedTree.from_local_trees(None, t(PTS[blk]), dt.tree,
                                           dt.top_lo, dt.top_hi, policy=pol)
    knn("flt", flt.query(P.nearest(qpts, k=3)))
err("err_few", lambda: DistributedTree(None, t(PTS[RANK:RANK + 1]), policy=pol))
if R_ > 1:
    err("err_unequal", lambda: DistributedTree(
        None, t(PTS[blk.start:blk.stop + (RANK == 0)]), policy=pol))
    err("err_unequal_q", lambda: dt.count(sph(0.3, QP[qb][:QL - (RANK == 0)])))

if "geo" in PARTS:
    bx = DistributedTree(None, G.Boxes(t(BOX_LO[blk]), t(BOX_HI[blk])), policy=pol)
    knn("box_knn5", bx.query(P.nearest(qpts, k=5)))
    out["box_count"] = bx.count(sph(0.1)).numpy()
    csr("box_csr", bx.query(sph(0.1)))
    for k in (1, 3):
        knn(f"box_ray{{k}}", bx.query(P.RayNearest(G.Rays(t(RAY_O[qb]), t(RAY_D[qb])), k)))
    tri = DistributedTree(None, G.Triangles(t(PTS[blk]), t(TRI_B[blk]), t(TRI_C[blk])),
                          policy=pol)
    for k in (1, 5):
        knn(f"tri_knn{{k}}", tri.query(P.nearest(qpts, k=k)))
    out["tri_count"] = tri.count(sph(0.1)).numpy()
    csr("tri_csr", tri.query(sph(0.1)))
save(**out)
print("PORT OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{R: (reference, port)} results of every world, all run at once."""
    tmp = tmp_path_factory.mktemp("distributed")

    def ref(r):
        path = os.path.join(tmp, f"ref{r}.npz")
        nl, ql, parts = WORLDS[r]
        code = REF.format(ranks=r, nl=nl, ql=ql, parts=parts).replace(
            "np.savez(OUT,", f"np.savez({path!r},")
        run_subprocess(code, devices=r, timeout=240)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def port(r):
        out = os.path.join(tmp, f"port{r}")
        os.makedirs(out)
        nl, ql, parts = WORLDS[r]
        run_world(PORT.format(ranks=r, nl=nl, ql=ql, parts=parts), r,
                  timeout=240,
                  out=out)
        return merge_ranks(world_results(out, r))

    with concurrent.futures.ThreadPoolExecutor(2 * len(WORLDS)) as pool:
        refs = {r: pool.submit(ref, r) for r in WORLDS}
        ports = {r: pool.submit(port, r) for r in WORLDS}
        return {r: (refs[r].result(), ports[r].result()) for r in WORLDS}


def _pair(runs, r):
    """(the reference's results, the port's) at R = r."""
    return runs[r]


def cases(part, keys):
    """(R, key) for every world that runs the scenario group `part`."""
    return [(r, key) for r in sorted(WORLDS) if part in WORLDS[r][2]
            for key in keys]


ALL_R = sorted(WORLDS)
MULTI_R = [r for r in ALL_R if r > 1]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_csr_sets(want, got, key):
    off_w, off_g = want[key + "_off"], got[key + "_off"]
    np.testing.assert_array_equal(off_g, off_w, err_msg=key)
    iw, ig = want[key + "_idx"], got[key + "_idx"]
    for q in range(len(off_w) - 1):
        np.testing.assert_array_equal(
            np.sort(ig[off_g[q]:off_g[q + 1]]),
            np.sort(iw[off_w[q]:off_w[q + 1]]), err_msg=f"{key} query {q}")


def _assert_knn(want, got, key):
    assert got[key + "_d"].shape == want[key + "_d"].shape
    np.testing.assert_array_equal(_bits(got[key + "_d"]),
                                  _bits(want[key + "_d"]), err_msg=key)
    assert_knn_equal(got[key + "_d"], got[key + "_i"], want[key + "_d"],
                     want[key + "_i"])


# ---------------------------------------------------------------------------
# kNN: distances bit-identical, indices equal except among ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,key", (
    cases("core", ["knn1", "knn5", "knn_big", "shipknn"])
    + cases("conf", ["rayax", "flt"])
    + cases("geo", ["box_knn5", "box_ray1", "box_ray3", "tri_knn1",
                    "tri_knn5"])))
def test_knn_matches_reference(runs, r, key):
    want, got = _pair(runs, r)
    if key == "knn_big":
        key = f"knn{WORLDS[r][0] + 3}"
    _assert_knn(want, got, key)


def test_k_above_the_block_pads_only_past_the_global_n(runs):
    """k = n_local + 3: every rank pads its list, the merge does not
    unless k exceeds all the values (one rank)."""
    for r in ALL_R:
        want, got = _pair(runs, r)
        nl = WORLDS[r][0]
        i = got[f"knn{nl + 3}_i"]
        assert ((i < 0).any(axis=1) == (r * nl < nl + 3)).all()


# ---------------------------------------------------------------------------
# counts, callback states and CSR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,key", (
    cases("core", ["count", "attach"])
    + cases("cb", ["mincb", "fsum", "mindist"])
    + cases("conf", ["countcomb"]) + cases("refuse", ["after_count"])
    + cases("geo", ["box_count", "tri_count"])))
def test_states_bit_identical(runs, r, key):
    want, got = _pair(runs, r)
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                  err_msg=key)


@pytest.mark.parametrize("r", [r for r, _ in cases("cb", ["fsum"])])
def test_float_sums_fold_in_rank_order(runs, r):
    """The float-sum state is one whose rounding depends on the order in
    which the ranks' partial sums are added: the reverse order differs
    somewhere, and the port, bit-identical to the reference's psum, adds
    them in rank order."""
    want, got = _pair(runs, r)
    parts = got["rank_fsum_part"]               # (R, Q): each rank's own
    fwd, rev = parts[0].copy(), parts[-1].copy()
    for p in parts[1:]:
        fwd = (fwd + p).astype(np.float32)
    for p in parts[-2::-1]:
        rev = (rev + p).astype(np.float32)
    assert (_bits(fwd) != _bits(rev)).any()
    np.testing.assert_array_equal(_bits(got["fsum"]), _bits(fwd))
    np.testing.assert_array_equal(_bits(want["fsum"]), _bits(fwd))


@pytest.mark.parametrize("r,key", (
    cases("core", ["csr", "cap", "trunc", "ship", "outs"])
    + cases("geo", ["box_csr", "tri_csr"])))
def test_csr_set_equal(runs, r, key):
    want, got = _pair(runs, r)
    _assert_csr_sets(want, got, key)


@pytest.mark.parametrize("r", ALL_R)
def test_capacity_doubling_and_overflow_flags(runs, r):
    want, got = _pair(runs, r)
    assert not got["rep_cap_over"] and not want["rep_cap_over"]
    assert got["rep_trunc_over"] and want["rep_trunc_over"]
    np.testing.assert_array_equal(np.diff(got["trunc_off"]),
                                  np.minimum(got["count"], 2))
    assert np.diff(got["cap_off"]).max() > 2    # the retry ran


# ---------------------------------------------------------------------------
# shipped values: bit-identical, signed zeros included
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", ALL_R)
@pytest.mark.parametrize("key", ["ship", "outs", "shipknn"])
def test_shipped_values_bit_identical(runs, r, key):
    """CSR order within a query is the walk's, so CSR values compare row
    by row with each query's matches sorted by index."""
    want, got = _pair(runs, r)
    if key == "shipknn":
        w, g = want["shipknn_val"], got["shipknn_val"]
    else:
        w = want[key + "_val"][_csr_order(want, key)]
        g = got[key + "_val"][_csr_order(got, key)]
    assert g.shape == w.shape
    np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)


@pytest.mark.parametrize("r", ALL_R)
def test_a_shipped_negative_zero_arrives_as_the_reference_sends_it(runs, r):
    """The -0.0 x of one point is shipped through the sum: +0.0 at R > 1
    (a +0.0 from another rank is added), -0.0 at R = 1, in both
    packages."""
    want, got = _pair(runs, r)
    xs = got["shipknn_val"][0, 0]           # query 0 sits on the point
    assert xs[0] == 0 and got["shipknn_d"][0, 0] == 0
    assert np.signbit(xs[0]) == (r == 1)
    assert np.signbit(want["shipknn_val"][0, 0, 0]) == (r == 1)
    assert got["rep_noship"] and want["rep_noship"]


# ---------------------------------------------------------------------------
# bounds, Q = 0, refusals and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", ALL_R)
def test_bounds_bit_identical_with_signed_zeros(runs, r):
    """Rank 0 holds a point at x = +0 and the last rank one at x = -0:
    the reference's min over its sharded top boxes keeps the earlier
    rank's zero (+0 when R > 1), and so does the port."""
    want, got = _pair(runs, r)
    for key in ("rep_bounds_lo", "rep_bounds_hi"):
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
    assert got["rep_bounds_lo"][0, 0] == 0
    assert np.signbit(got["rep_bounds_lo"][0, 0]) == (r == 1)


@pytest.mark.parametrize("r,key", cases(
    "conf", ["rep_q0_knn", "rep_q0_off", "rep_q0_count", "rep_q0_cb",
             "rep_q0_ship"]))
def test_empty_batches(runs, r, key):
    want, got = _pair(runs, r)
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("r,key", (
    cases("refuse", ["err_ordered", "err_out", "err_exclude"])
    + cases("conf", ["err_flt_leaves", "err_flt_nodes", "err_flt_top"])
    + cases("core", ["err_few"])))
def test_refusals_raise_on_every_rank(runs, r, key):
    """merge_ranks checked that every rank raised the same type; the
    world went on to answer later queries, so no rank hung."""
    want, got = _pair(runs, r)
    assert str(got[key]) == str(want[key]) != "none"


@pytest.mark.parametrize("r", MULTI_R)
@pytest.mark.parametrize("key", ["err_unequal", "err_unequal_q"])
def test_unequal_blocks_raise_on_every_rank(runs, r, key):
    want, got = _pair(runs, r)
    assert str(got[key]) == str(want[key]) == "ValueError"


def _csr_order(res, key):
    """Row order that sorts each query's CSR segment by index."""
    off, idx = res[key + "_off"], res[key + "_idx"]
    seg = np.repeat(np.arange(len(off) - 1), np.diff(off))
    return np.lexsort((idx, seg))
