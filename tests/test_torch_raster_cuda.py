"""The rasterizer's CUDA kernels (raster_setup, raster_bin, raster_fwd,
raster_bwd) against the plain PyTorch binning and raster step, on the card.

Needs a CUDA card and nvcc, and imports no JAX, so it runs on a machine
without it: ``python -m pytest tests/test_torch_raster_cuda.py --noconftest
-m cuda -q`` (the suite's conftest imports jax). Where no card exists the
tests skip.

Binning: the face lists, counts and overflow identical to ``_bin_faces``.
Forward: three launches, no ``[tiles, F]`` block; ``pix_to_face``,
``mask`` and ``depth`` identical (the edge
functions, barycentrics and depths round op by op as the plain version's
do), ``attr`` to 1e-6, the silhouette to 1e-5 (its log-sum runs in another
order, with sign / length multiplied in). Backward: each gradient within 1e-4 of
the plain version's autograd, relative to its largest magnitude (atomicAdd
order and the sums' order differ)."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import raster as rk
from icon_tpu_torch.ops.raster import rasterize, rasterize_plain
from icon_tpu_torch.render.camera import verts_to_ndc
from icon_tpu_torch.utils.synthetic import synthetic_body

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the raster kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(subdiv, az, C, seed, dev):
    v, f = synthetic_body(subdiv=subdiv)
    rng = np.random.RandomState(seed)
    ndc = verts_to_ndc(torch.from_numpy(v), az).to(dev)
    attrs = torch.from_numpy(rng.randn(len(v), C).astype(np.float32)).to(dev)
    return ndc, torch.from_numpy(f).long().to(dev), attrs


CASES = [(5, 512, 256, 3, 0.0), (5, 512, 96, 3, 180.0), (5, 1024, 512, 1, 0.0),
         (3, 100, 64, 2, 30.0)]


@pytest.mark.parametrize("subdiv,size,K,C,az", CASES)
def test_forward_matches_plain(cuda_device, subdiv, size, K, C, az):
    ndc, f, attrs = _scene(subdiv, az, C, size + K, cuda_device)
    before = (rk.launches_setup, rk.launches_bin, rk.launches_fwd)
    out = rasterize(ndc, f, attrs, H=size, W=size, K=K)
    torch.cuda.synchronize()
    assert (rk.launches_setup, rk.launches_bin, rk.launches_fwd) == \
        tuple(n + 1 for n in before)
    ref = rasterize_plain(ndc, f, attrs, H=size, W=size, K=K)
    assert torch.equal(out.pix_to_face, ref.pix_to_face)
    assert torch.equal(out.mask, ref.mask)
    assert torch.equal(out.depth, ref.depth)
    assert int(out.bin_overflow) == int(ref.bin_overflow)
    assert float((out.attr - ref.attr).abs().max()) <= 1e-6
    assert float((out.silhouette - ref.silhouette).abs().max()) <= 1e-5
    # the body covers 2-7% of the image (less where K drops faces)
    assert float(out.mask.sum()) > 0.01 * size * size


def _grads(fn, ndc, f, attrs, size, K, weights):
    v = ndc.clone().requires_grad_(True)
    a = attrs.clone().requires_grad_(True)
    out = fn(v, f, a, H=size, W=size, K=K)
    wa, wd, ws = weights
    loss = (out.attr * wa).sum() + (out.depth * out.mask * wd).sum() + \
        (out.silhouette * ws).sum()
    gv, ga = torch.autograd.grad(loss, (v, a))
    return gv, ga


@pytest.mark.parametrize("subdiv,size,K,C,az", CASES)
def test_backward_matches_plain(cuda_device, subdiv, size, K, C, az):
    ndc, f, attrs = _scene(subdiv, az, C, size + K + 1, cuda_device)
    rng = np.random.RandomState(size)
    weights = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device) for s in ((size, size, C), (size, size), (size, size))]
    before = rk.launches_bwd
    got = _grads(rasterize, ndc, f, attrs, size, K, weights)
    torch.cuda.synchronize()
    assert rk.launches_bwd == before + 1
    want = _grads(rasterize_plain, ndc, f, attrs, size, K, weights)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0
        assert float((g - w).abs().max()) <= 1e-4 * scale


def test_silhouette_only_grad(cuda_device):
    """A loss on the silhouette alone (the fit's mask term) and one on the
    attributes alone (the cloth loop's normal term)."""
    ndc, f, attrs = _scene(4, 0.0, 3, 0, cuda_device)
    for pick in (lambda o: o.silhouette.sum(), lambda o: o.attr[..., 1].sum()):
        grads = []
        for fn in (rasterize, rasterize_plain):
            v = ndc.clone().requires_grad_(True)
            gv, = torch.autograd.grad(pick(fn(v, f, attrs, H=256, W=256,
                                              K=256)), (v,))
            grads.append(gv)
        scale = float(grads[1].abs().max())
        assert scale > 0 and torch.isfinite(grads[0]).all()
        assert float((grads[0] - grads[1]).abs().max()) <= 1e-4 * scale


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    ndc, f, attrs = _scene(2, 0.0, 3, 0, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        rasterize(ndc.double(), f, attrs.double(), H=64, W=64, K=16)
    with pytest.raises(ValueError, match="K <="):
        rasterize(ndc, f, attrs, H=64, W=64, K=4096)
    with pytest.raises(ValueError, match="32-px tiles"):
        rasterize(ndc, f, attrs, H=64, W=64, K=16, tile=16)
    with pytest.raises(ValueError, match="several devices"):
        rk.rasterize(ndc.cpu(), f, attrs, 64, 64)


@pytest.mark.parametrize("subdiv,size,K,az", [(5, 512, 96, 0.0),
                                               (5, 512, 256, 90.0),
                                               (5, 1024, 32, 0.0),
                                               (6, 256, 32, 30.0)])
def test_bin_kernel_matches_plain(cuda_device, subdiv, size, K, az):
    """Every slot of every tile, the counts and the overflow equal
    ``_bin_faces``'s, including tiles with more than K faces."""
    ndc, f, _ = _scene(subdiv, az, 1, 0, cuda_device)
    # push some faces off screen on each side
    ndc = ndc * torch.tensor([1.6, 1.6, 1.0], device=cuda_device)
    lists, counts, overflow = rk.bin_faces(ndc, f, size, size, K=K)
    torch.cuda.synchronize()
    ref = rk.bin_faces_plain(ndc, f, size, size, K=K)
    assert int(ref[2]) > 0                # some tile overflows
    assert torch.equal(lists.long(), ref[0])
    assert torch.equal(counts.long(), ref[1])
    assert int(overflow) == int(ref[2])


def test_forward_allocates_no_tiles_by_faces_block(cuda_device):
    """A forward on the card needs its images, the slot data, the face
    lists and the split blocks' scratch: less than a one-byte [tiles, F]
    matrix (the plain binning's overlap mask) at 327,680 faces."""
    ndc, f, attrs = _scene(7, 0.0, 3, 0, cuda_device)
    size, K = 1024, 512
    rasterize(ndc, f, attrs, H=size, W=size, K=K)       # warm the cache
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = rasterize(ndc, f, attrs, H=size, W=size, K=K)
    torch.cuda.synchronize()
    delta = torch.cuda.max_memory_allocated() - base
    n_tiles = (size // 32) ** 2
    assert delta < n_tiles * f.shape[0]
    assert int(out.mask.sum()) > 0


@pytest.mark.parametrize("az", [0.0, 90.0, 180.0, 270.0])
def test_turntable_raster_matches_plain(cuda_device, az):
    """The demo's turntable frame (``render/render.py:
    make_turntable_renderer``: 256^2, K=128, forward only): the subdiv-6
    body (81,920 faces, far past K in its tiles: about 84k (tile, face)
    pairs dropped, some 120 pixels left covered) rotated about y on the
    host and flipped to NDC by (1, -1, -1); the frame and the raster
    identical to the plain version's, the overflow equal and non-zero,
    one launch of each forward kernel per frame."""
    from icon_tpu_torch.render.render import make_turntable_renderer
    v, f = synthetic_body(subdiv=6)
    a = np.radians(az)
    rot = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, 1.0, 0.0],
                    [np.sin(a), 0.0, np.cos(a)]], np.float32)
    v_rot = torch.from_numpy(v @ rot.T).to(cuda_device)
    colors = torch.from_numpy(np.random.RandomState(3).rand(
        len(v), 3).astype(np.float32)).to(cuda_device)
    faces = torch.from_numpy(f).long().to(cuda_device)
    before = (rk.launches_setup, rk.launches_bin, rk.launches_fwd)
    frame = make_turntable_renderer(faces, colors, size=256, K=128)(v_rot)
    torch.cuda.synchronize()
    assert (rk.launches_setup, rk.launches_bin, rk.launches_fwd) == \
        tuple(n + 1 for n in before)
    ndc = v_rot * torch.tensor([1.0, -1.0, -1.0], device=cuda_device)
    out = rasterize(ndc, faces, colors, H=256, W=256, K=128)
    ref = rasterize_plain(ndc, faces, colors, H=256, W=256, K=128)
    assert torch.equal(out.pix_to_face, ref.pix_to_face)
    assert int(out.bin_overflow) == int(ref.bin_overflow) > 0
    m = ref.mask[..., None]
    want = ref.attr * m + 0.5 * (1.0 - m)
    assert float((frame - want).abs().max()) <= 1e-6
    assert float(ref.mask.sum()) > 50
