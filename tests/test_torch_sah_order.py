"""``core.lbvh.sah_cost`` bit for bit against the reference's jitted
``sah_cost`` in dims 1-3. XLA:CPU rewrites ``jnp.sum`` of M > 32 values
into windows of 32 (the padding split around them, half in front), sums
each window in sequence and then the window sums the same way, and the
fusion that computes the 3-D measures beside that sum contracts two of
the three products into fused multiply-adds; up to 32 values it keeps the
products apart and sums in sequence. The port reproduces both
(``lbvh._surface_measure(fused=...)``, ``lbvh._xla_sum``). Tolerance 0:
the float32 bits are compared. The tests of ``service.IndexStore``
keep their relative tolerance (``SAH_RTOL``) on the costs they compare.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL

#: leaf counts around the window (M = N - 1 internal nodes: 16, 31, 32,
#: 33 and 64 measures), two levels of windows (1057, 4097), and N = 2
NS = (2, 17, 32, 33, 34, 65, 1057, 4097)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _boxes(n, dim, seed):
    """Seeded boxes, a quarter of them points (zero extents)."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    hi = (lo + rng.uniform(0, 0.5, (n, dim))).astype(np.float32)
    hi[::4] = lo[::4]
    return lo, hi


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_sah_cost_is_the_references_bit_for_bit(dim, n):
    import jax.numpy as jnp
    from repro.core import geometry as JG
    from repro.core import lbvh as JL
    lo, hi = _boxes(n, dim, 31 * n + dim)
    want = np.asarray(JL.sah_cost(JL.build(JG.Boxes(jnp.asarray(lo),
                                                    jnp.asarray(hi)))))
    got = TL.sah_cost(TL.build(TG.Boxes(torch.from_numpy(lo),
                                        torch.from_numpy(hi)))).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.view(np.int32) == want.view(np.int32), (float(got),
                                                       float(want))


def test_xla_sum_windows():
    """The windowed order on a constructed input where it differs from a
    sequential sum: 2^24 first, then ones (a sequential float32 sum never
    moves; the windows of ones sum exactly first)."""
    x = torch.ones(70, dtype=torch.float32)
    x[0] = 2.0 ** 24
    seq = torch.zeros((), dtype=torch.float32)
    for v in x:
        seq = seq + v
    assert float(seq) == 2.0 ** 24
    # 70 values: 96 slots, 13 zeros in front and 13 behind; the windows
    # hold 2^24 and 18 ones (each lost), 32 ones, and 19 ones; then
    # 2^24 + 32 is exact and 2^24 + 32 + 19 rounds to even, 2^24 + 52
    assert float(TL._xla_sum(x)) == 2.0 ** 24 + 52


@pytest.mark.parametrize("step", [-1, 0, 1])
def test_refit_or_rebuild_at_the_threshold_as_the_reference(step):
    """``IndexStore.update`` compares the refit tree's cost with
    ``rebuild_threshold`` × the build's. With the threshold at the exact
    ratio of the two costs and one ulp either side, the port's store
    refits or rebuilds as the reference's does: the costs, and so the
    decision, are the same floats."""
    import jax.numpy as jnp
    import repro.service as RS
    from repro.core import geometry as JG
    from repro_torch.service import IndexStore
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    moved = (base + rng.normal(0, 0.05, base.shape)).astype(np.float32)
    probe = IndexStore(device="cpu")
    built = probe.build("pts", TG.Points(torch.from_numpy(base))).sah_built
    refit = TL.sah_cost(TL.refit(probe.get("pts").bvh.tree, TG.Boxes(
        torch.from_numpy(moved), torch.from_numpy(moved))))
    ratio = float(refit) / built
    threshold = float(np.nextafter(ratio, np.inf if step > 0 else -np.inf)
                      if step else ratio)
    port = IndexStore(device="cpu", rebuild_threshold=threshold)
    ref = RS.IndexStore(rebuild_threshold=threshold)
    port.build("pts", TG.Points(torch.from_numpy(base)))
    ref.build("pts", JG.Points(jnp.asarray(base)))
    got = port.update("pts", TG.Points(torch.from_numpy(moved)))
    want = ref.update("pts", JG.Points(jnp.asarray(moved)))
    assert (got.sah, got.sah_built) == (want.sah, want.sah_built)
    assert got.action == want.action
