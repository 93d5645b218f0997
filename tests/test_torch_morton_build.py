"""PyTorch port vs the JAX package: Morton codes, the Karras ranges kernel's
twin, and the LBVH build, refit and SAH cost (CPU, seeded numpy inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import cloud, np_of, one_torch_thread  # noqa: F401 (fixture)
from repro.core import geometry as JG
from repro.core import lbvh as JL
from repro.core import morton as JM
from repro.kernels import lbvh_build as JK
from repro_torch import convert
from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import morton as TM
from repro_torch.kernels import lbvh_build as TK


def _u32(x):
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# (a) Morton codes, sort permutation, deltas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "duplicates"])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 8])
def test_morton_codes_sort_and_deltas_match(dim, kind):
    x = cloud(300, dim, kind, seed=dim)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert TM.bits_per_dim(dim) == (min(64 // dim, 21) if dim <= 6 else 64 // dim)

    jhi, jlo = JM.morton64(jx)
    thi, tlo = TM.morton64(tx)
    np.testing.assert_array_equal(_u32(jhi), np_of(thi))
    np.testing.assert_array_equal(_u32(jlo), np_of(tlo))
    np.testing.assert_array_equal(_u32(JM.morton32(jx)), np_of(TM.morton32(tx)))

    jperm = np.arange(300, dtype=np.int32)
    (jhs, jls), jp = JM.sort_by_morton((jhi, jlo), jnp.asarray(jperm))
    (ths, tls), tp = TM.sort_by_morton((thi, tlo), torch.arange(300))
    np.testing.assert_array_equal(np.asarray(jp), np_of(tp))
    jd = JM.delta_from_keys(*JM.combined_delta_key((jhs, jls), 300))
    td = TM.delta_from_keys(*TM.combined_delta_key((ths, tls), 300))
    np.testing.assert_array_equal(np.asarray(jd), np_of(td))


def test_sort_orders_codes_with_bit_63_set():
    """dim 4 uses all 64 bits: codes >= 2^63 must sort after the rest."""
    hi = torch.tensor([0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 0], dtype=torch.int64)
    lo = torch.tensor([0, 0xFFFFFFFF, 5, 7], dtype=torch.int64)
    _, perm = TM.sort_by_morton((hi, lo), torch.arange(4))
    assert perm.tolist() == [3, 1, 0, 2]


def test_clz32_is_exact():
    vals = [0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x00010000,
            0x0000FFFF, 0x00800000]
    vals += [1 << b for b in range(32)] + [(1 << b) - 1 for b in range(1, 33)]
    vals += np.random.default_rng(0).integers(0, 1 << 32, 500).tolist()
    x = np.array(vals, dtype=np.uint32)
    want = np.asarray(JM._clz32(jnp.asarray(x)))
    got = np_of(TM._clz32(torch.tensor(vals, dtype=torch.int64)))
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# (b) karras_ranges twin vs karras_ranges_fused and the Pallas kernel
# ---------------------------------------------------------------------------

def _sorted_keys(x):
    n = x.shape[0]
    jhi, jlo = JM.morton64(jnp.asarray(x))
    (jhs, jls), _ = JM.sort_by_morton((jhi, jlo), jnp.arange(n, dtype=jnp.int32))
    return JM.combined_delta_key((jhs, jls), n)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
@pytest.mark.parametrize("n", [2, 3, 17, 1000])
def test_karras_twin_matches_fused_and_pallas(n, kind):
    x = cloud(n, 3, kind, seed=n)
    jkeys = _sorted_keys(x)
    ml2 = max((n - 1).bit_length(), 1)
    fused = JK.karras_ranges_fused(*jkeys, n, ml2)
    pallas = JK.karras_ranges_pallas(*jkeys, n, ml2, interpret=True)
    tkeys = [torch.from_numpy(_u32(k)) for k in jkeys]
    twin = TK.karras_ranges(*tkeys, n, ml2)          # CPU tensors: the twin
    for f, p, t in zip(fused, pallas, twin):
        np.testing.assert_array_equal(np.asarray(f), np_of(t))
        np.testing.assert_array_equal(np.asarray(p), np_of(t))
        assert t.dtype == torch.int32


# ---------------------------------------------------------------------------
# (c) build: all 8 LBVH fields node for node; refit; sah_cost
# ---------------------------------------------------------------------------

def _both_builds(lo, hi, bits=64):
    jt = JL.build(JG.Boxes(jnp.asarray(lo), jnp.asarray(hi)), bits=bits)
    tt = TL.build(TG.Boxes(torch.from_numpy(lo), torch.from_numpy(hi)), bits=bits)
    return jt, tt


def _assert_same_tree(jt, tt):
    got = convert.lbvh_to_numpy(tt)
    for f in TL.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)), got[f],
                                      err_msg=f)
        assert got[f].dtype == np.asarray(getattr(jt, f)).dtype, f


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
@pytest.mark.parametrize("n,dim", [(2, 3), (3, 2), (17, 5), (1000, 3),
                                   (1000, 2)])
def test_build_fields_equal_node_for_node(n, dim, kind):
    lo = cloud(n, dim, kind, seed=7 * n + dim)
    hi = lo + np.random.default_rng(n).uniform(0, 0.05, lo.shape).astype(np.float32)
    jt, tt = _both_builds(lo, hi)
    _assert_same_tree(jt, tt)
    assert tt.num_leaves == n and tt.dim == dim


def test_build_bits32_and_point_values():
    x = cloud(500, 3, "uniform", seed=3)
    jt, tt = _both_builds(x, x, bits=32)
    _assert_same_tree(jt, tt)


def test_refit_matches_reference():
    x = cloud(600, 3, "uniform", seed=11)
    jt, tt = _both_builds(x, x)
    moved = (x + np.random.default_rng(1).normal(0, 0.02, x.shape)).astype(np.float32)
    jr = JL.refit(jt, JG.Boxes(jnp.asarray(moved), jnp.asarray(moved)))
    tr = TL.refit(tt, TG.Boxes(torch.from_numpy(moved), torch.from_numpy(moved)))
    _assert_same_tree(jr, tr)
    with pytest.raises(ValueError, match="same leaf count"):
        TL.refit(tt, TG.Boxes(torch.zeros((5, 3)), torch.zeros((5, 3))))


@pytest.mark.parametrize("dim", [1, 2, 3, 5])
def test_sah_cost_matches_reference(dim):
    """Same surface measures; the final sum over nodes runs in another
    order than XLA's, so the ratio agrees to float32 rounding (rtol 1e-5)."""
    x = cloud(400, dim, "clustered", seed=dim)
    jt, tt = _both_builds(x, x + np.float32(0.01))
    np.testing.assert_allclose(float(TL.sah_cost(tt)),
                               float(JL.sah_cost(jt)), rtol=1e-5)


def test_lbvh_numpy_roundtrip_and_device_move():
    x = cloud(50, 3, "uniform", seed=2)
    jt, _ = _both_builds(x, x)
    fields = {f: np.asarray(getattr(jt, f)) for f in TL.FIELDS}
    tree = convert.lbvh_from_numpy(fields, "cpu")
    _assert_same_tree(jt, tree.to("cpu"))
    with pytest.raises(KeyError):
        convert.lbvh_from_numpy({"node_lo": fields["node_lo"]})


def test_build_rejects_unported_options():
    b = TG.Boxes(torch.zeros((4, 3)), torch.ones((4, 3)))
    with pytest.raises(ValueError, match="bits"):
        TL.build(b, bits=16)
    with pytest.raises(ValueError, match="N >= 2"):
        TL.build(TG.Boxes(torch.zeros((1, 3)), torch.zeros((1, 3))))


def test_jax_side_stays_on_cpu():
    assert jax.default_backend() == "cpu"
