"""The rasterizer's CUDA kernels (raster_fwd, raster_bwd) against the plain
PyTorch raster step, on the card.

Needs a CUDA card and nvcc, and imports no JAX, so it runs on a machine
without it: ``python -m pytest tests/test_torch_raster_cuda.py --noconftest
-m cuda -q`` (the suite's conftest imports jax). Where no card exists the
tests skip.

Forward: ``pix_to_face``, ``mask`` and ``depth`` identical (the edge
functions, barycentrics and depths round op by op as the plain version's
do), ``attr`` to 1e-6, the silhouette to 1e-5 (its log-sum runs in another
order, with the card's expf/log1pf). Backward: each gradient within 1e-4 of
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
    before = rk.launches_fwd
    out = rasterize(ndc, f, attrs, H=size, W=size, K=K)
    torch.cuda.synchronize()
    assert rk.launches_fwd == before + 1
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
    with pytest.raises(ValueError, match="several devices"):
        rk.raster(ndc[f][..., :2].cpu(), ndc[f][..., 2], attrs[f],
                  torch.zeros((4, 8), dtype=torch.int64, device=cuda_device),
                  None, 64, 64)
