"""Port parity, the rasterizer and the renders: icon_tpu_torch.ops.raster,
render.camera and render.render against the JAX package on the meshes of
tests/test_raster.py and on the subdiv-3 synthetic body.

``pix_to_face`` must agree on at least 99.9% of the covered pixels (a depth
tie on a shared edge may go either way if the two float32 edge functions
differ in the last bit); ``attr``, ``depth`` and ``silhouette`` to 1e-5
where the faces agree; ``mask`` and ``bin_overflow`` equal; vertex
visibility identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_raster import square_mesh
from torch_port_helpers import t

from icon_tpu.utils.synthetic import synthetic_body
from icon_tpu_torch.ops.raster import rasterize, vertex_visibility

ATOL = 1e-5
RNG = np.random.RandomState(7)


def _meshes():
    """name -> (verts_ndc, faces, attrs): the test_raster.py scenes and the
    body turned 30 degrees, with random attributes."""
    from icon_tpu.render.camera import verts_to_ndc
    out = {"square": square_mesh(half=0.5)}
    (v1, f1, a1), (v2, f2, a2) = (square_mesh(z=0.2, half=0.5, attr=(1, 0, 0)),
                                  square_mesh(z=0.1, half=0.25,
                                              attr=(0, 1, 0)))
    out["two_squares"] = (np.concatenate([v1, v2]),
                          np.concatenate([f1, f2 + 4]),
                          np.concatenate([a1, a2]))
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    out["triangle"] = (tri, np.array([[0, 1, 2]], np.int32), tri[:, :1].copy())
    v, f = synthetic_body(subdiv=3)
    out["body"] = (np.asarray(verts_to_ndc(jnp.asarray(v), 30.0)), f,
                   RNG.randn(len(v), 3).astype(np.float32))
    return out


MESHES = _meshes()


def check_raster(ref, out):
    """The agreement bounds of the module docstring."""
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert int(out.bin_overflow) == int(ref.bin_overflow)
    pf, rpf = out.pix_to_face.numpy(), np.asarray(ref.pix_to_face)
    covered = rpf >= 0
    same = pf == rpf
    assert (~same & covered).sum() <= 1e-3 * covered.sum()
    for got, want in ((out.attr, ref.attr), (out.depth, ref.depth)):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.silhouette.numpy(),
                               np.asarray(ref.silhouette), rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_rasterize_parity(name, size):
    from icon_tpu.ops.raster import rasterize as jrasterize
    v, f, a = MESHES[name]
    K = 16 if name != "body" else 512
    ref = jrasterize(jnp.asarray(v), jnp.asarray(f), jnp.asarray(a), H=size,
                     W=size, K=K)
    out = rasterize(t(v), t(f, torch.int64), t(a), H=size, W=size, K=K)
    assert out.attr.shape == (size, size, a.shape[1])
    check_raster(ref, out)
    assert float(out.mask.sum()) > 0.05 * size * size
    assert int(out.bin_overflow) == 0


def test_bin_overflow_and_chunking():
    """A face list too short for the body's tiles drops pairs as the JAX
    binning does; the chunk size changes no output."""
    from icon_tpu.ops.raster import rasterize as jrasterize
    v, f, a = MESHES["body"]
    ref = jrasterize(jnp.asarray(v), jnp.asarray(f), jnp.asarray(a), H=64,
                     W=64, K=24)
    outs = [rasterize(t(v), t(f, torch.int64), t(a), H=64, W=64, K=24,
                      tiles_per_step=n) for n in (1, 3, 64)]
    assert int(ref.bin_overflow) > 0
    check_raster(ref, outs[0])
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_vertex_visibility_parity():
    from icon_tpu.ops.raster import vertex_visibility as jvis
    v, f = synthetic_body(subdiv=3)
    ref = np.asarray(jvis(jnp.asarray(v), jnp.asarray(f), res=256))
    out = vertex_visibility(t(v), t(f, torch.int64), res=256)
    assert out.shape == (len(v), 1)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.3 * len(v) < ref.sum() < 0.7 * len(v)

    # the occlusion scene of tests/test_raster.py
    v3 = np.concatenate([square_mesh(z=0.5, half=0.2)[0],
                         square_mesh(z=0.1, half=0.6)[0]])
    f3 = np.concatenate([square_mesh()[1], square_mesh()[1] + 4])
    vis3 = vertex_visibility(t(v3), t(f3, torch.int64), res=256).numpy()
    np.testing.assert_array_equal(
        vis3, np.asarray(jvis(jnp.asarray(v3), jnp.asarray(f3), res=256)))
    np.testing.assert_array_equal(vis3[:, 0], [0] * 4 + [1] * 4)


def test_camera_parity():
    from icon_tpu.render import camera as jcam
    from icon_tpu_torch.render import camera
    v, _ = synthetic_body(subdiv=3)
    for az in (0.0, 30.0, 90.0, 180.0, 270.0):
        np.testing.assert_array_equal(camera.view_matrix(az),
                                      jcam.view_matrix(az))
        np.testing.assert_allclose(
            camera.verts_to_ndc(t(v), az).numpy(),
            np.asarray(jcam.verts_to_ndc(jnp.asarray(v), az)), rtol=0,
            atol=1e-6)
    assert camera.ortho_views() == jcam.ortho_views()


@pytest.mark.parametrize("fn", ["render_normal", "render_normal_sil",
                                "render_silhouette", "render_depth",
                                "render_color", "query_color"])
def test_render_parity(fn):
    """Each ported render function on the body at 64^2 (azimuth 180 where
    it takes one), against the JAX function."""
    from icon_tpu.render import render as jrender
    from icon_tpu_torch.render import render
    v, f = synthetic_body(subdiv=3)
    colors = RNG.uniform(0, 1, (len(v), 3)).astype(np.float32)
    image = RNG.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    if fn == "query_color":
        args, kw = (image,), {}
    elif fn == "render_color":
        args, kw = (colors,), {"size": 64, "azimuth": 180.0}
    else:
        args, kw = (), {"size": 64, "azimuth": 180.0}
    ref = getattr(jrender, fn)(jnp.asarray(v), jnp.asarray(f),
                               *map(jnp.asarray, args), **kw)
    out = getattr(render, fn)(t(v), t(f, torch.int64), *map(t, args), **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(ref) == len(out)
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
