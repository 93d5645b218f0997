"""The port's per-device cost analysis (``repro_torch.launch.opanalysis``)
held to the asserts the reference's HLO analyzer passes in
``tests/test_system.py``, and the dry-run's per-device argument bytes
(``repro_torch.launch.dryrun``) against the local shard bytes that the
reference's own specs and shapes imply.

The fake-backend process groups these tests join (a private torch
testing API) are torn down at the end of each test, so that no later
test of the same worker finds one.
"""
import math

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch import mesh as TM
from repro_torch.launch import opanalysis as OA


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()

    def join(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    try:
        yield join
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_analyzer_matches_known_workload():
    """12 chained (256 x 256) products and a sum: FLOPs within [want, 1.05
    want], and the streaming model touches every weight once."""
    m, k_iters = 256, 12
    x = torch.randn(m, m)
    ws = torch.randn(k_iters, m, m)

    def f(x, ws):
        for i in range(k_iters):
            x = x @ ws[i]
        return x.sum()

    r = OA.analyze(f, x, ws)
    want = 2 * m ** 3 * k_iters
    assert want <= r["flops"] <= want * 1.05
    assert r["hbm_bytes"] >= k_iters * m * m * 4
    assert r["collectives"] == {} and r["collective_bytes"] == 0.0
    # the products' results are the temporaries: two live at a time
    assert 2 * m * m * 4 <= r["temp_bytes"] <= 3 * m * m * 4


def test_analyzer_counts_collectives_in_loops(fake_world):
    """A gather inside a 10-trip loop on a fake 8-rank mesh is charged
    every trip."""
    fake_world(8)
    mesh = TM.make_mesh((8,), ("d",), "cpu")
    x = DTensor.from_local(torch.empty(64, 8), mesh, [Shard(1)],
                           run_check=False)
    w = DTensor.from_local(torch.empty(64, 64), mesh, [Replicate()],
                           run_check=False)

    def f(c, w):
        for _ in range(10):
            c = (c.redistribute(mesh, [Replicate()]) @ w).redistribute(
                mesh, [Shard(1)])
        return c

    r = OA.analyze(f, x, w)
    per_iter = 64 * 64 * 4
    assert r["collective_bytes"] >= 5 * per_iter, r["collectives"]
    assert r["collectives"]["all-gather"] == 10 * per_iter
    assert r["top_collectives"][0][1] == "all-gather"
    assert r["top_collectives"][0][3] == 10


def test_analyzer_counts_per_device_flops(fake_world):
    """A column-parallel product on a 2 x 2 fake mesh: each rank's local
    (16 x 64) . (64 x 32), not the global (32 x 64) . (64 x 64)."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), "cpu")
    x = DTensor.from_local(torch.randn(16, 64), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.randn(64, 32), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    r = OA.analyze(lambda a, b: a @ b, x, w)
    assert r["flops"] == 2 * 16 * 32 * 64
    assert r["collective_bytes"] == 0.0
    assert r["hbm_bytes"] == (16 * 64 + 64 * 32 + 16 * 32) * 4
    assert r["out_bytes"] == 16 * 32 * 4


def test_analyzer_counts_pointwise_and_reductions_once_an_element():
    a = torch.randn(100, 10)
    r = OA.analyze(lambda t: torch.exp(t).sum(-1), a)
    assert r["flops"] == 100 * 10 + 100
    r = OA.analyze(lambda t: t.view(10, 100).transpose(0, 1), a)
    assert r["flops"] == 0 and r["hbm_bytes"] == 0 and r["temp_bytes"] == 0


def _ref_local_bytes(struct, specs, sizes):
    """Local shard bytes of a reference pytree of ShapeDtypeStructs at
    `specs` on a mesh of `sizes`."""
    import jax
    total = 0
    leaves = jax.tree_util.tree_leaves(struct)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            shape[d] = math.ceil(shape[d] / math.prod(sizes[a] for a in axes))
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_decode_bytes_are_the_reference_specs_local_shards(multi_pod):
    """``run_cell("tinyllama-1.1b", "decode_32k")`` on meta: its
    arg_bytes are the parameters (ZeRO-1 specs: the FSDP knob), the
    cache and the tokens, each at the reference's specs, as local shards,
    exactly."""
    from jax.sharding import AbstractMesh, PartitionSpec as JP
    from repro.configs import get_config as j_get_config
    from repro.launch import sharding as JSH
    from repro.launch import specs as JSP
    from repro_torch.launch import dryrun
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    sizes = dict(zip(axes, shape))
    jmesh = AbstractMesh(shape, axes)
    cfg = j_get_config("tinyllama-1.1b")
    ps = JSP.params_struct(cfg)
    pspecs = JSH.zero1_specs(JSH.param_specs(ps, jmesh), ps, jmesh)
    cache = JSP.cache_struct(cfg, "decode_32k")
    cspecs = JSH.cache_specs(cfg, cache, jmesh, 128)
    batch = JSP.input_specs(cfg, "decode_32k")
    bspecs = {k: JP(*(list(JSH.batch_spec(jmesh, v.shape[0]))
                      + [None] * (v.ndim - 1))) for k, v in batch.items()}
    want = (_ref_local_bytes(ps, pspecs, sizes)
            + _ref_local_bytes(cache, cspecs, sizes)
            + _ref_local_bytes(batch, bspecs, sizes))
    try:
        rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k",
                              multi_pod=multi_pod, verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["arg_bytes"] == want
    assert rec["chips"] == math.prod(shape)
    assert rec["flops_per_device"] > 0 and rec["temp_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert "not the allocator's" in rec["note"]


def test_dryrun_records_a_skipped_cell_and_a_failure(monkeypatch):
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]

    def boom(*a, **k):
        raise RuntimeError("no rule for this op")

    monkeypatch.setattr(dryrun, "setup_cell", boom)
    try:
        rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "failed"
    assert rec["error"] == "RuntimeError: no rule for this op"
