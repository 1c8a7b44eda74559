"""The voxelize CUDA kernels against their plain PyTorch twins, on the card.

``box_smooth3d`` must equal the plain version bit for bit (the same sums in
the same order, true divisions). ``voxel_splat``'s float atomics add in an
order that changes from run to run: every term is non-negative, so each
voxel of m terms may differ from the plain sum by at most 2 m 2^-24 of it
(``ops/voxelize.py:splat_terms``). The backward kernels must equal their
plain twins bit for bit (the same operations in the same order, no
atomics): ``box_smooth3d_bwd`` at the rows the splat's backward reads
(``touched_rows``) against ``box_smooth3d_bwd_rows_plain`` and the dense
``box_smooth3d_bwd_plain``, ``voxel_splat_bwd`` against
``voxel_splat_bwd_plain``; the whole gradient through ``voxelize_semantic``
on the card equals the CPU's to ``GRAD_RTOL`` of its largest value (the
forward splat's atomics).

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
# the card's gradient against the CPU's: the forward splat's summation
# order moves each voxel by a few 2^-24 of its sum, which the division by
# the weight and the box's sums pass on
GRAD_RTOL = 1e-5


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
    # an input that needs a gradient is taken: the backward kernels give it
    v = verts.clone().requires_grad_(True)
    before = (kv.launches_splat_bwd, kv.launches_smooth_bwd)
    kv.voxelize_semantic(v, codes, res=16).sum().backward()
    torch.cuda.synchronize()
    assert (kv.launches_splat_bwd, kv.launches_smooth_bwd) == \
        (before[0] + 1, before[1] + 1)
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())
    assert float(v.grad.abs().max()) > 0
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
    z = torch.zeros(1, 8, 8, 8, 3, device=cuda_device)
    with pytest.raises(ValueError, match=f"k <= {kv.MAX_K}"):
        kv._voxelize_bwd(verts, codes, z, z,
                         torch.zeros(1, 8, 8, 8, device=cuda_device), 8,
                         kv.MAX_K + 1)
    with torch.no_grad():             # no gradient asked: the kernels run
        kv.voxel_splat(verts.clone().requires_grad_(True), codes, 16)


def _grad_inputs(shape, seed, dev, ties=None):
    """(g_out, out, weight) of the smooth's backward: ``out`` and ``weight``
    from the plain forward of a sparse accumulator, 32 weights set to the
    floor 1e-3 exactly and 32 below it (at the flat voxels ``ties`` of the
    volume when given, else at random ones), and a random ``g_out``."""
    rng = np.random.RandomState(seed)
    acc = rng.rand(*shape, 4).astype(np.float32)
    acc[rng.rand(*shape) < 0.7] = 0.0
    acc[..., 3] *= 0.02                       # weights around the floor
    out, weight = pv.box_smooth3d_plain(torch.from_numpy(acc).to(dev), 1,
                                        keep_weight=True)
    weight = weight.contiguous()
    flat = weight.view(-1)
    idx = torch.from_numpy(rng.choice(flat.numel(), 64, replace=False)) \
        if ties is None else ties[:64].cpu()
    flat[idx[:32].to(dev)] = 1e-3
    flat[idx[32:].to(dev)] = 5e-4
    g_out = torch.from_numpy(rng.randn(*shape, 3).astype(np.float32))
    return g_out.to(dev), out.contiguous(), weight


def _windows(rows, shape, k):
    """``[B, D, H, W]`` bool: the voxels the mirrored k-box windows of the
    flat ``rows`` read."""
    import torch.nn.functional as F
    lo = k - 1 - k // 2
    m = torch.zeros(int(np.prod(shape)), device=rows.device)
    m[rows] = 1.0
    m = F.pad(m.view(shape[0], 1, *shape[1:]), (k - 1 - lo, lo) * 3)
    return F.max_pool3d(m, k, stride=1)[:, 0] > 0


def _rows_held(g_out, out, weight, k, verts):
    """box_smooth3d_bwd's kernels against both twins at the touched rows,
    twice, the scratch filled with ones before the second call (the call
    zeroes its count and marks itself); they count no launch. Returns the
    kernels' output."""
    B, res = out.shape[0], out.shape[1]
    rows = pv.touched_rows(verts, res)
    want = pv.box_smooth3d_bwd_rows_plain(g_out, out, weight, k, rows)
    dense = pv.box_smooth3d_bwd_plain(g_out, out, weight, k)
    assert torch.equal(want, dense.view(-1, 4)[rows])
    before = kv.launches_smooth_bwd
    scratch = kv._bwd_scratch(B, res, k, out.device)
    got = torch.empty_like(dense)
    for _ in range(2):
        kv._smooth_bwd(g_out, out, weight, k, verts, scratch, got)
        torch.cuda.synchronize()
        assert torch.equal(got.view(-1, 4)[rows], want)
        scratch.fill_(1)
    assert kv.launches_smooth_bwd == before
    return got


@pytest.mark.parametrize("shape,k", [((1, 128, 128, 128), 11),
                                     ((2, 33, 33, 33), 3),
                                     ((1, 64, 64, 64), 4),
                                     ((1, 9, 9, 9), 1),
                                     ((1, 128, 128, 128), 2)])
def test_box_smooth3d_bwd_is_bit_identical(cuda_device, shape, k):
    verts, _ = _inputs(shape[0], 3000, False, k, cuda_device, pad=1000)
    res = shape[1]
    rows = pv.touched_rows(verts, res)
    # the ties at rows and, where the window is wider than a voxel, beside
    # them: inside the windows the kernels read
    inside = _windows(rows, shape, k)
    near = rows if k == 1 else torch.cat([rows, rows + 1, rows + res])
    near = torch.unique(near.clamp(max=int(np.prod(shape)) - 1))
    near = near[inside.view(-1)[near]]
    ties = near[torch.randperm(len(near), generator=torch.Generator()
                               .manual_seed(k))[:64].to(near.device)]
    g_out, out, weight = _grad_inputs(shape, k, cuda_device, ties)
    assert int(((weight == 1e-3) & inside).sum()) >= 32
    assert int(((weight < 1e-3) & inside).sum()) >= 32
    _rows_held(g_out, out, weight, k, verts)


@pytest.mark.parametrize("k", [75, kv.MAX_K])
def test_box_smooth3d_bwd_one_plane_bricks(cuda_device, k):
    """Past k = 74 a brick is one plane: its rows against the dense twin
    (the row twin's windows of k^3 voxels a row are too large here)."""
    shape = (1, 20, 20, 20)
    verts, _ = _inputs(1, 200, False, k, cuda_device, pad=100)
    rows = pv.touched_rows(verts, shape[1])
    g_out, out, weight = _grad_inputs(shape, k, cuda_device, rows)
    dense = pv.box_smooth3d_bwd_plain(g_out, out, weight, k)
    got = torch.empty_like(dense)
    kv._smooth_bwd(g_out, out, weight, k, verts,
                   kv._bwd_scratch(1, shape[1], k, cuda_device), got)
    torch.cuda.synchronize()
    assert torch.equal(got.view(-1, 4)[rows], dense.view(-1, 4)[rows])
    assert float(dense.view(-1, 4)[rows].abs().max()) > 0


def _footprint(name, dev):
    """(verts, codes): phase 18a's kind of input (642 vertices, the rest
    at one point with zero codes), the dense footprint (the body's first
    8,000 vertices, ``kernels/profile_voxelize.py``) or two padded entries
    with their own codes."""
    if name == "dense":
        from icon_tpu_torch.kernels.profile_voxelize import voxel_input
        return voxel_input(dev)
    if name == "padded":
        return _inputs(1, 8000, False, 18, dev, pad=7358)
    return _inputs(2, 8000, True, 19, dev, pad=(7358, 5438))


@pytest.mark.parametrize("name", ["padded", "dense", "batched"])
def test_backward_kernels_on_footprints(cuda_device, name):
    """Both backward kernels at PaMIR's 128^3 and k = 11 on the forward's
    own output and weight: the box at the touched rows, then the splat's
    backward on the box's output against its twin on those rows alone,
    and the entry (one launch of each) against both."""
    verts, codes = _footprint(name, cuda_device)
    B, res, k = verts.shape[0], 128, 11
    out, weight = kv.box_smooth3d(kv.voxel_splat(verts, codes, res).view(
        B, res, res, res, 4), k, keep_weight=True)
    g_out = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(7))
    got = _rows_held(g_out, out, weight, k, verts)
    rows = pv.touched_rows(verts, res)
    clean = torch.zeros(B * res ** 3, 4, device=cuda_device)
    clean[rows] = got.view(-1, 4)[rows]
    gv, gc = torch.empty_like(verts), torch.empty_like(codes)
    kv._splat_bwd(verts, codes, got.view(B, -1, 4), res, gv, gc)
    want_v, want_c = pv.voxel_splat_bwd_plain(verts, codes,
                                              clean.view(B, -1, 4), res)
    before = (kv.launches_splat_bwd, kv.launches_smooth_bwd)
    ev, ec = kv._voxelize_bwd(verts, codes, g_out, out, weight, res, k)
    torch.cuda.synchronize()
    assert (kv.launches_splat_bwd, kv.launches_smooth_bwd) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(gv, want_v) and torch.equal(gc, want_c)
    assert torch.equal(ev, want_v) and torch.equal(ec, want_c)
    assert float(gv.abs().max()) > 0


@pytest.mark.parametrize("k", [11, 4])
def test_box_smooth3d_keeps_its_weight(cuda_device, k):
    """Under a gradient the forward also writes the smoothed weight; its
    output stays bit-identical to the plain version, and so does the
    weight."""
    rng = np.random.RandomState(k)
    acc = rng.rand(1, 64, 64, 64, 4).astype(np.float32)
    acc[rng.rand(1, 64, 64, 64) < 0.7] = 0.0
    acc = torch.from_numpy(acc).to(cuda_device)
    out, weight = kv.box_smooth3d(acc, k, keep_weight=True)
    want, want_w = pv.box_smooth3d_plain(acc, k, keep_weight=True)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(weight, want_w)
    assert torch.equal(kv.box_smooth3d(acc, k), want)


@pytest.mark.parametrize("B,V,batched,res,pad", [
    (1, 8000, False, 128, 3000), (2, 5000, True, 64, 0),
    (2, 3000, False, 32, 0), (1, 100, False, 7, 0),
    (2, 8000, True, 128, (7358, 5438))])
def test_splat_bwd_is_bit_identical(cuda_device, B, V, batched, res, pad):
    verts, codes = _inputs(B, V, batched, res + 1, cuda_device, pad)
    verts[:, :25, 0] = -1.0                 # on the grid's end planes
    verts[:, 25:50, 1:] = 1.0
    g_acc = torch.randn(B, res ** 3, 4, device=cuda_device)
    before = kv.launches_splat_bwd
    gv, gc = torch.empty_like(verts), torch.empty_like(codes)
    kv._splat_bwd(verts, codes, g_acc, res, gv, gc)
    torch.cuda.synchronize()
    assert kv.launches_splat_bwd == before
    want_v, want_c = pv.voxel_splat_bwd_plain(verts, codes, g_acc, res)
    assert torch.equal(gv, want_v) and torch.equal(gc, want_c)
    only_v = torch.empty_like(verts)
    kv._splat_bwd(verts, codes, g_acc, res, only_v, None)
    torch.cuda.synchronize()
    assert torch.equal(only_v, want_v)


def test_voxelize_semantic_grad_matches_cpu(cuda_device):
    """PaMIR's voxelization at 128^3 under a gradient on the card (four
    kernels) against the same Function on the CPU (the plain twins)."""
    verts, codes = _inputs(1, 8000, False, 7, cuda_device, pad=5000)
    r = torch.randn(1, 128, 128, 128, 3, device=cuda_device)
    grads = {}
    for name, dev in (("gpu", cuda_device), ("cpu", torch.device("cpu"))):
        v = verts.to(dev).clone().requires_grad_(True)
        c = codes.to(dev).clone().requires_grad_(True)
        (kv.voxelize_semantic(v, c, res=128) * r.to(dev)).sum().backward()
        grads[name] = (v.grad.cpu(), c.grad.cpu())
    for got, want in zip(grads["gpu"], grads["cpu"]):
        assert bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0
        assert float((got - want).abs().max()) <= \
            GRAD_RTOL * float(want.abs().max())
