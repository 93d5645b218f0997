"""PyTorch port vs the JAX package: ``ray_box_nearest`` (the flat
box-soup nearest ray hit), its plain twin against the reference's Pallas
kernel in interpret mode (``repro.kernels.ops.ray_box_nearest``), and
the CUDA kernel against the twin on the card (``cuda``).

t is compared bit for bit (tolerance 0: the slab test sums no products)
and the box index exactly (the lowest index on equal t). The inputs hold
duplicated boxes (ties), rays that miss everything, zero direction
components, origins on a box face, and R and B that are multiples of
neither the reference's blocks (256, 512) nor the kernel's (128, 256).
The JAX package is imported inside the tests that use it, so that the
``cuda`` case also runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch import BVH, ExecutionPolicy, raytracing
from repro_torch import kernels as TKS
from repro_torch.core import geometry as TG
from repro_torch.kernels import ray_box as TR


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch thread per pytest worker (the suite runs several)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_of(x):
    return x.detach().cpu().numpy()


def case(r, b, dim=3, seed=0):
    """(origins, directions, box_lo, box_hi) float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 1, (b, dim)).astype(np.float32)
    hi = (lo + rng.uniform(0.01, 0.1, (b, dim))).astype(np.float32)
    dup = np.arange(1, b, 5)
    lo[dup], hi[dup] = lo[dup - 1], hi[dup - 1]          # equal-t ties
    o = rng.uniform(0, 1, (r, dim)).astype(np.float32)
    d = rng.normal(size=(r, dim)).astype(np.float32)
    j = rng.integers(0, b, r)
    aim = np.arange(r) % 3 == 0
    d[aim] = (0.5 * (lo[j] + hi[j]) - o)[aim]
    d[2::7, rng.integers(0, dim)] = 0.0                  # zero components
    o[4::9] = np.where(np.arange(dim) == 0, lo[j[4::9]], o[4::9])  # on a face
    o[5::11] += 10.0                                     # far away: misses
    d[5::11] = np.abs(d[5::11])
    return o, d.astype(np.float32), lo, hi


@pytest.mark.parametrize("r,b,dim", [(1, 1, 3), (37, 1001, 3),
                                     (300, 700, 3), (64, 513, 2),
                                     (20, 130, 5)])
def test_twin_bit_identical_to_reference(r, b, dim):
    from repro.kernels.ops import ray_box_nearest as j_ray_box_nearest
    o, d, lo, hi = case(r, b, dim, seed=r + b)
    wt, wi = map(np.asarray, j_ray_box_nearest(o, d, lo, hi))
    gt, gi = TR.ray_box_nearest(*(torch.from_numpy(a) for a in (o, d, lo, hi)))
    np.testing.assert_array_equal(wt, np_of(gt))
    np.testing.assert_array_equal(wi, np_of(gi))
    assert gt.dtype == torch.float32 and gi.dtype == torch.int32
    if r > 1:
        assert (wi >= 0).any() and (wi < 0).any()


def test_twin_panels_do_not_change_the_answer(monkeypatch):
    """Panel boundaries inside the box axis (ties across panels keep the
    first box)."""
    o, d, lo, hi = (torch.from_numpy(a) for a in case(50, 403, seed=4))
    want = TR.ray_box_nearest_ref(o, d, lo, hi)
    monkeypatch.setattr(TR, "_PANEL_ELEMENTS", 50 * 3 * 7)
    got = TR.ray_box_nearest_ref(o, d, lo, hi)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_matches_cast_nearest_over_a_bvh_of_the_boxes():
    """The flat kernel's contract is cast_nearest(k=1) over BVH(Boxes):
    t bit-identical, the box equal wherever the minimum is unique."""
    o, d, lo, hi = (torch.from_numpy(a) for a in case(200, 600, seed=9))
    t, i = TR.ray_box_nearest(o, d, lo, hi)
    index = BVH(TG.Boxes(lo, hi), policy=ExecutionPolicy(device="cpu"))
    tk, ik = raytracing.cast_nearest(index, TG.Rays(o, d), k=1)
    assert torch.equal(t, tk[:, 0])
    _, tall = TG.ray_box(o[:, None], d[:, None], lo[None], hi[None])
    unique = (tall == t[:, None]).sum(1) == 1
    assert bool(unique.any()) and bool((~unique & (i >= 0)).any())
    assert torch.equal(i[unique], ik[unique, 0])


def test_exported_and_validated():
    assert TKS.ray_box_nearest is TR.ray_box_nearest
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="float32"):
        TR.ray_box_nearest(o.double(), o.double(), o.double(), o.double())
    with pytest.raises(ValueError, match=r"\(B, dim\)"):
        TR.ray_box_nearest(o, o, torch.zeros((4, 2)), torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="dim must be"):
        z = torch.zeros((2, 17))
        TR.ray_box_nearest(z, z, z, z)
    t, i = TR.ray_box_nearest(o, o, torch.zeros((0, 3)), torch.zeros((0, 3)))
    assert bool(torch.isinf(t).all()) and bool((i == -1).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r,b,dim", [(37, 1001, 3), (300, 700, 2),
                                     (2049, 1, 3), (3, 3, 3), (100, 255, 3),
                                     (1025, 257, 3), (1029, 4097, 3),
                                     (64, 513, 5)])
def test_kernel_matches_twin_on_the_card(cuda_device, r, b, dim):
    args = [torch.from_numpy(a) for a in case(r, b, dim, seed=r)]
    before = TR.ray_box_nearest.launches
    t, i = TR.ray_box_nearest(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert TR.ray_box_nearest.launches == before + 1
    wt, wi = TR.ray_box_nearest_ref(*args)
    assert torch.equal(t.cpu(), wt) and torch.equal(i.cpu(), wi)


@pytest.mark.cuda
@pytest.mark.parametrize("r,b,splits", [(1500, 200, 1), (1500, 700, 3),
                                        (1500, 3000, 12), (1 << 17, 6912, 9)])
def test_kernel_splits_match_twin_on_the_card(cuda_device, r, b, splits):
    """The 3-D kernel with the box axis whole, cut in three, cut into
    single tiles, and cut into ranges of three tiles (each block refills
    its two-stage ring): identical to the twin, run on the card here."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    got_splits, chunk = TR.plan(r, b, sms)
    if sms == 132:
        assert got_splits == splits
    args = [torch.from_numpy(a).to(cuda_device)
            for a in case(r, b, 3, seed=11)]
    t, i = TR.ray_box_nearest(*args)
    wt, wi = TR.ray_box_nearest_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(t, wt) and torch.equal(i, wi)
