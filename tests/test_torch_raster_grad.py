"""Port parity, the rasterizer's gradients: autograd through the plain
``icon_tpu_torch.ops.raster.rasterize`` against ``jax.grad`` of
``icon_tpu.ops.raster.rasterize``, with respect to ``verts_ndc`` and
``attrs``, of seeded weighted sums of the attributes, the depth and the soft
silhouette, on the subdiv-3 body (a face list long enough for every tile,
and one short enough to drop faces); and of the SMPL fit's loss through
``render_normal_sil`` (vertex normals, both views, the silhouette term)
with respect to the body's vertices.

Each gradient to 1e-5 of its largest magnitude: the per-pixel terms are the
same float32 ops, summed in another order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu.utils.synthetic import synthetic_body
from icon_tpu_torch.ops.raster import rasterize

GRAD_RTOL = 1e-5


def _scene(seed):
    from icon_tpu.render.camera import verts_to_ndc
    v, f = synthetic_body(subdiv=3)
    rng = np.random.RandomState(seed)
    return (np.asarray(verts_to_ndc(jnp.asarray(v), 30.0)), f,
            rng.randn(len(v), 3).astype(np.float32))


def _pick(out, term):
    return {"attr": out.attr, "depth": (out.depth * out.mask)[..., None],
            "silhouette": out.silhouette[..., None]}[term]


def _assert_grads_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("term", ["attr", "depth", "silhouette"])
@pytest.mark.parametrize("size,K", [(64, 96), (128, 512)])
def test_raster_grad_parity(size, K, term):
    from icon_tpu.ops.raster import rasterize as jrasterize
    ndc, f, attrs = _scene(size + K)
    w = np.random.RandomState(size).randn(
        size, size, 3 if term == "attr" else 1).astype(np.float32)

    def jloss(x, a):
        out = jrasterize(x, jnp.asarray(f), a, H=size, W=size, K=K)
        return jnp.sum(_pick(out, term) * w)

    jgx, jga = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ndc),
                                                jnp.asarray(attrs))
    x = t(ndc).requires_grad_(True)
    a = t(attrs).requires_grad_(True)
    out = rasterize(x, t(f, torch.int64), a, H=size, W=size, K=K)
    assert (int(out.bin_overflow) > 0) == (K == 96)
    loss = torch.sum(_pick(out, term) * t(w))
    loss.backward()
    _assert_grads_close(x.grad, jgx)
    if term == "attr":
        _assert_grads_close(a.grad, jga)
    else:           # depth and silhouette do not read the attributes
        assert a.grad is None or not a.grad.any()
        assert not np.asarray(jga).any()


@pytest.mark.parametrize("size", [64, 128])
def test_fit_loss_grad_parity(size):
    """The SMPL fit's per-iteration loss (infer/refine.py, mask branch) as a
    function of the body's vertices: normals and silhouettes of both views
    at K=96."""
    from icon_tpu.render.render import render_normal_sil as jrender
    from icon_tpu_torch.render.render import render_normal_sil
    v, f = synthetic_body(subdiv=3)
    rng = np.random.RandomState(size)
    goal = [rng.uniform(-1, 1, (size, size, 3)).astype(np.float32)
            for _ in range(2)]
    mask = (rng.rand(size, size) > 0.7).astype(np.float32)

    def loss(render, xp, verts, faces, goals, gt):
        total = 0.0
        for az, g in zip((0.0, 180.0), goals):
            n, _, sil = render(verts, faces, size=size, azimuth=az, K=96)
            total = total + xp.mean(xp.abs(n - g)) + \
                0.5 * xp.mean(xp.abs(sil - gt))
        return total

    jl, jg = jax.value_and_grad(lambda x: loss(
        jrender, jnp, x, jnp.asarray(f), goal, mask))(jnp.asarray(v))
    x = t(v).requires_grad_(True)
    pl = loss(render_normal_sil, torch, x, t(f, torch.int64),
              [t(g) for g in goal], t(mask))
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-6)
    _assert_grads_close(x.grad, jg)
