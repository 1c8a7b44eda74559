"""Port parity, ops core: each icon_tpu_torch op against its JAX
counterpart on the same numpy inputs, to 1e-5 absolute (float32 sums taken
in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu.ops import grid_sample as jgs
from icon_tpu.ops import mesh as jmesh
from icon_tpu.ops import projection as jproj
from icon_tpu.ops import resize as jresize
from icon_tpu.ops import select as jsel
from icon_tpu.ops import voxelize as jvox
from icon_tpu_torch.ops import grid_sample, mesh, projection, resize, \
    select, voxelize

ATOL = 1e-5
RNG = np.random.RandomState(7)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("rows", [3, 4])
def test_project_orthogonal(rows):
    pts = RNG.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    calib = RNG.randn(2, rows, 4).astype(np.float32)
    ref = jproj.project(jnp.asarray(pts), jnp.asarray(calib))
    _close(projection.project(t(pts), t(calib)), ref)
    # perspective (ported): depths kept away from 0 by the calibration
    calib[:, 2, :3] *= 0.1
    calib[:, 2, 3] = 3.0
    ref = jproj.project(jnp.asarray(pts), jnp.asarray(calib),
                        mode="perspective")
    _close(projection.project(t(pts), t(calib), mode="perspective"), ref)


def test_grid_sample_2d_zero_padding():
    feat = RNG.randn(2, 9, 13, 5).astype(np.float32)
    uv = RNG.uniform(-1.2, 1.2, (2, 300, 2)).astype(np.float32)
    uv[0, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]     # exact corners
    ref = jgs.grid_sample_2d(jnp.asarray(feat), jnp.asarray(uv))
    _close(grid_sample.grid_sample_2d(t(feat), t(uv)), ref)


def test_feat_select():
    feat = RNG.randn(1, 40, 12).astype(np.float32)
    sel = (RNG.rand(1, 40, 1) > 0.5).astype(np.float32)
    ref = jsel.feat_select(jnp.asarray(feat), jnp.asarray(sel))
    np.testing.assert_array_equal(select.feat_select(t(feat), t(sel)),
                                  np.asarray(ref))


def test_upsample2x_bicubic():
    x = RNG.randn(2, 7, 5, 3).astype(np.float32)              # NHWC
    ref = jresize.upsample2x_bicubic(jnp.asarray(x))
    out = resize.upsample2x_bicubic(t(x).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("shape,out", [((9, 9, 9), (17, 17, 17)),
                                       ((5, 7, 6), (9, 4, 11))])
def test_resize3d_trilinear_align_corners(shape, out):
    x = RNG.randn(1, *shape, 2).astype(np.float32)           # [B,D,H,W,C]
    ref = jresize.resize3d_trilinear_align_corners(jnp.asarray(x), out)
    got = resize.resize3d_trilinear_align_corners(
        t(x).permute(0, 4, 1, 2, 3), out)
    _close(got.permute(0, 2, 3, 4, 1), ref)


def test_resize3d_indicator_exact_on_engine_ladder():
    """A 0/1 indicator upsamples bit-exactly on the 2x-odd ladder, so the
    engine's boundary test (0 < v < 1) matches the JAX package's."""
    x = (RNG.rand(1, 9, 9, 9, 1) > 0.5).astype(np.float32)
    ref = jresize.resize3d_trilinear_align_corners(jnp.asarray(x),
                                                   (17, 17, 17))
    got = resize.resize3d_trilinear_align_corners(
        t(x).permute(0, 4, 1, 2, 3), (17, 17, 17))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("k", [3, 7, 9])
def test_smooth_conv3d(k):
    vol = RNG.randn(1, 11, 12, 13, 1).astype(np.float32)
    ref = jvox.smooth_conv3d(jnp.asarray(vol), k)
    got = voxelize.smooth_conv3d(t(vol)[..., 0], k)
    _close(got, np.asarray(ref)[..., 0])


def test_vertex_normals_and_barycentric_weights():
    from icon_tpu.utils.synthetic import synthetic_body
    v, f = synthetic_body(subdiv=2)
    v = v + 0.01 * RNG.randn(*v.shape).astype(np.float32)
    ref = jmesh.vertex_normals(jnp.asarray(v[None]), jnp.asarray(f))
    _close(mesh.vertex_normals(t(v[None]), t(f, torch.int64)), ref)

    tri = RNG.randn(64, 3, 3).astype(np.float32)
    tri[0] = tri[0, 0]                                   # degenerate face
    pts = RNG.randn(64, 3).astype(np.float32)
    ref = jmesh.barycentric_projection_weights(jnp.asarray(pts),
                                               jnp.asarray(tri))
    got = mesh.barycentric_projection_weights(t(pts), t(tri))
    _close(got, ref)


def test_clothed_human_field():
    """utils.synthetic: the frame's analytic field, sdf and occupancy."""
    from icon_tpu.utils import synthetic as jsyn
    from icon_tpu_torch.utils import synthetic as psyn
    pts = RNG.uniform(-1, 1, (3000, 3)).astype(np.float32)
    _close(psyn.clothed_human_sdf(t(pts)),
           jsyn.clothed_human_sdf(jnp.asarray(pts)))
    occ = psyn.clothed_human_occ(t(pts))
    _close(occ, jsyn.clothed_human_occ(jnp.asarray(pts)))
    assert 0.01 < float((occ > 0.5).float().mean()) < 0.3


def test_synthetic_icon_batch():
    """utils.synthetic: one seed gives both packages the same batch."""
    from icon_tpu.utils import synthetic as jsyn
    from icon_tpu_torch.utils import synthetic as psyn
    kw = dict(B=2, image_size=16, n_samples=32, subdiv=2)
    ref = jsyn.synthetic_icon_batch(np.random.RandomState(3), **kw)
    got = psyn.synthetic_icon_batch(np.random.RandomState(3), **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
