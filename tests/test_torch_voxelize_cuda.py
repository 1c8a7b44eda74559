"""The voxelize CUDA kernels against their plain PyTorch twins, on the card.

``box_smooth3d`` must equal the plain version bit for bit (the same sums in
the same order, true divisions). ``voxel_splat``'s float atomics add in an
order that changes from run to run: every term is non-negative, so each
voxel of m terms may differ from the plain sum by at most 2 m 2^-24 of it
(``ops/voxelize.py:splat_terms``).

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_voxelize_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import voxelize as kv
from icon_tpu_torch.ops import voxelize as pv

pytestmark = pytest.mark.cuda

ORDER_EPS = 2.0 ** -24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the voxelize kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _inputs(B, V, batched, seed, dev, pad=0):
    """``pad``: the last ``pad`` vertices of every batch entry, or the last
    ``pad[b]`` of entry b, at one point with zero codes (``pamir_feats``'s
    padding: ~5,400-7,400 of its 8,000 vertices)."""
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-0.6, 0.6, (B, V, 3)).astype(np.float32)
    verts[:, :V // 20] *= 1.8                    # some corners outside
    codes = rng.rand(*((B, V, 3) if batched else (V, 3))).astype(np.float32)
    pads = pad if isinstance(pad, tuple) else (pad,) * B
    for b, n in enumerate(pads):                 # the demo's zero padding
        if n:
            verts[b, -n:] = 0.0
            (codes[b] if batched else codes)[-n:] = 0.0
    return (torch.from_numpy(verts).to(dev), torch.from_numpy(codes).to(dev))


def splat_within_order_bound(got, want, verts, res):
    terms = pv.splat_terms(verts, res)[..., None].float()
    tol = 2.0 * terms * ORDER_EPS * want.abs()
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("B,V,batched,res,pad", [
    (1, 8000, False, 128, 3000), (2, 5000, True, 64, 0),
    (1, 100, False, 7, 0),
    (1, 8000, False, 128, 7358),                 # the padding's stress
    (2, 8000, True, 128, (7358, 5438))])
def test_splat_matches_plain(cuda_device, B, V, batched, res, pad):
    verts, codes = _inputs(B, V, batched, res, cuda_device, pad)
    before = kv.launches_splat
    got = kv.voxel_splat(verts, codes, res)
    torch.cuda.synchronize()
    assert kv.launches_splat == before + 1
    want = pv.voxel_splat_plain(verts, codes, res)
    assert got.shape == want.shape == (B, res ** 3, 4)
    assert splat_within_order_bound(got, want, verts, res)
    # a second launch on dirty memory: the accumulator is zeroed first
    again = kv.voxel_splat(verts, codes, res)
    assert splat_within_order_bound(again, want, verts, res)


@pytest.mark.parametrize("shape,k", [((1, 128, 128, 128), 11),
                                     ((2, 33, 17, 40), 3),
                                     ((1, 64, 64, 64), 4),
                                     ((1, 9, 9, 9), 1),
                                     ((1, 128, 128, 128), 23),
                                     ((1, 128, 128, 128), 2)])
def test_box_smooth3d_is_bit_identical(cuda_device, shape, k):
    rng = np.random.RandomState(k)
    acc = rng.rand(*shape, 4).astype(np.float32)
    acc[rng.rand(*shape) < 0.7] = 0.0            # sparse, like a splat
    acc = torch.from_numpy(acc).to(cuda_device)
    keep = acc.clone()
    before = kv.launches_smooth
    got = kv.box_smooth3d(acc, k)
    torch.cuda.synchronize()
    assert kv.launches_smooth == before + 1
    want = pv.box_smooth3d_plain(acc, k)
    assert got.shape == want.shape == shape + (3,)
    assert torch.equal(got, want)
    assert torch.equal(acc, keep)                # the input is left as it is


def test_division_by_k_is_correctly_rounded(cuda_device):
    """The smooth's division by k (``x * RN(1/k)`` corrected by its exact
    residual) equals IEEE division for every float32 significand and
    every k the kernel takes; each step scales with x's exponent, so one
    binade stands for all the exponents the kernel sends there."""
    assert kv.division_mismatches(kv.MAX_K) == 0


def test_voxelize_semantic_matches_plain(cuda_device):
    verts, codes = _inputs(1, 8000, False, 5, cuda_device, pad=2000)
    got = kv.voxelize_semantic(verts, codes, res=128)
    acc = pv.voxel_splat_plain(verts, codes, 128)
    want = pv.box_smooth3d_plain(acc.view(1, 128, 128, 128, 4), 11)
    assert got.shape == (1, 128, 128, 128, 3)
    assert bool(torch.isfinite(got).all())
    # the splat's ulps pass through a sum of 11^3 box taps and a division
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("kernel", ["voxel_splat", "box_smooth3d"])
def test_kernels_reject_a_misaligned_accumulator(cuda_device, kernel):
    """The kernels move float4: an accumulator whose base is not 16-byte
    aligned is refused before any launch."""
    verts, codes = _inputs(1, 100, False, 0, cuda_device)
    res = 16
    bad = torch.zeros(res ** 3 * 4 + 1, device=cuda_device)[1:]
    before = (kv.launches_splat, kv.launches_smooth)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "voxel_splat":
            kv._splat(verts, codes, res, bad.view(1, res ** 3, 4))
        else:
            kv.box_smooth3d(bad.view(1, res, res, res, 4), 3)
    assert (kv.launches_splat, kv.launches_smooth) == before


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    verts, codes = _inputs(1, 100, False, 0, cuda_device)
    with pytest.raises(NotImplementedError, match="A10"):
        kv.voxel_splat(verts.clone().requires_grad_(True), codes, 16)
    with pytest.raises(TypeError):
        kv.voxel_splat(verts.double(), codes, 16)
    with pytest.raises(ValueError):
        kv.voxel_splat(verts, codes[:, :2].contiguous(), 16)
    with pytest.raises(ValueError):
        kv.voxel_splat(verts, codes.t().contiguous().t(), 16)
    with pytest.raises(ValueError):
        kv.box_smooth3d(torch.zeros(1, 8, 8, 8, 3, device=cuda_device), 3)
    with pytest.raises(ValueError, match=f"k <= {kv.MAX_K}"):
        kv.box_smooth3d(torch.zeros(1, 8, 8, 8, 4, device=cuda_device),
                        kv.MAX_K + 1)
    with torch.no_grad():             # no gradient asked: the kernels run
        kv.voxel_splat(verts.clone().requires_grad_(True), codes, 16)
