"""Port parity, PaMIR's semantic voxelization and the volume sampling:
``ops/voxelize.py:voxelize_semantic`` (the plain version of the voxelize
kernels) against the JAX package's at res 32 (codes per vertex and per
batch item, vertices outside [-1, 1], the default and explicit box sizes)
to 1e-6 absolute (the same float32 sums, in the same order but for XLA's
scatter); the kernels' wrapper on CPU tensors takes the plain version and
counts no launch; the splat's weights are a partition of unity;
``grid_sample_3d`` and ``index`` against the JAX gathers, points outside
the volume included, to 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu_torch.kernels import voxelize as kv
from icon_tpu_torch.ops import voxelize as pv

RNG = np.random.RandomState(21)


def _verts(B: int, V: int, spread: float = 0.7):
    v = RNG.uniform(-spread, spread, (B, V, 3)).astype(np.float32)
    return v


@pytest.mark.parametrize("batched,outside,k", [
    (False, False, None), (True, False, None), (False, True, None),
    (True, True, 5), (False, False, 1),
])
def test_voxelize_plain_matches_jax(batched, outside, k):
    from icon_tpu.ops.voxelize import voxelize_semantic as jvox
    B, V = 2, 400
    verts = _verts(B, V)
    if outside:                  # some corners or whole vertices outside
        verts[:, :40] *= 1.6
        verts[0, 40] = [1.0, -1.0, 0.99]
    codes = RNG.rand(*((B, V, 3) if batched else (V, 3))).astype(np.float32)
    want = np.asarray(jvox(jnp.asarray(verts), jnp.asarray(codes), res=32,
                           smooth_kernel=k))
    got = pv.voxelize_semantic(t(verts), t(codes), res=32, smooth_kernel=k)
    assert got.shape == (B, 32, 32, 32, 3) and float(got.max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = (kv.launches_splat, kv.launches_smooth)
    np.testing.assert_array_equal(
        kv.voxelize_semantic(t(verts), t(codes), res=32,
                             smooth_kernel=k).numpy(), got.numpy())
    assert (kv.launches_splat, kv.launches_smooth) == before


def test_default_box_size():
    """k = 11 at res 128 and sigma 0.05, 3 at res 32 (the JAX formula)."""
    assert pv.smooth_kernel_size(128, 0.05) == 11
    assert pv.smooth_kernel_size(32, 0.05) == 3
    assert pv.smooth_kernel_size(8, 0.05) == 1


def test_splat_weights_and_terms():
    """Each vertex whose eight corners lie inside adds weights summing to 1
    (and its codes times them); corners outside add nothing; the term
    counts are the corners of positive weight per voxel."""
    verts = _verts(1, 300)
    verts[0, :30] = 1.3                           # all corners outside
    codes = RNG.rand(300, 3).astype(np.float32)
    acc = kv.voxel_splat(t(verts), t(codes), 16)
    assert acc.shape == (1, 16 ** 3, 4)
    np.testing.assert_allclose(float(acc[..., 3].sum()), 270.0, rtol=1e-5)
    np.testing.assert_allclose(acc[..., :3].sum((0, 1)).numpy(),
                               codes[30:].sum(0), rtol=1e-5)
    terms = pv.splat_terms(t(verts), 16)
    assert int(terms.sum()) <= 270 * 8 and int(terms.sum()) > 270 * 7
    assert bool(((terms > 0) == (acc[..., 3] > 0)).all())
    smooth = kv.box_smooth3d(acc.view(1, 16, 16, 16, 4), 3)
    np.testing.assert_array_equal(
        smooth.numpy(), pv.box_smooth3d_plain(acc.view(1, 16, 16, 16, 4),
                                              3).numpy())


@pytest.mark.parametrize("k,rz,tile", [
    (11, 8, (64, 16)),           # PaMIR's box at res 128, sigma 0.05
    (23, 16, (64, 16)),          # the default box of a 256^3 volume
    (1, 2, (64, 16)), (2, 2, (64, 16)), (3, 4, (64, 16)), (4, 4, (64, 16)),
    (80, 16, (32, 16)), (90, 16, (16, 16)), (100, 16, (16, 8)),
    (kv.MAX_K, 16, (8, 8))])
def test_smooth_geometry(k, rz, tile):
    """The launch ``box_smooth3d`` picks per k: the D pass's outputs a
    thread (its ``slide`` needs k >= rz - 1), the first tile whose halo and
    H lines fit 227 KB of shared memory."""
    g = kv.smooth_geometry(k)
    assert (g.rz, (g.tx, g.ty)) == (rz, tile)
    assert k >= g.rz - 1
    hx = g.tx + k - 1                             # csrc/voxelize.cu's smem
    assert kv.smooth_smem(k, g.tx, g.ty) == \
        16 * (hx * (g.ty + k - 1) + g.ty * hx) <= kv.MAX_SMEM
    bigger = kv.TILES[:kv.TILES.index(tile)]
    assert all(kv.smooth_smem(k, *t) > kv.MAX_SMEM for t in bigger)


def test_smooth_geometry_refuses_past_the_limit():
    """k = 109 is the largest box whose 8 x 8 tile fits; past it, and below
    1, the wrapper raises with the limit before any launch."""
    assert kv.MAX_K == 109
    assert kv.smooth_smem(110, 8, 8) > kv.MAX_SMEM
    for k in (0, kv.MAX_K + 1):
        with pytest.raises(ValueError, match="1 <= k <= 109"):
            kv.smooth_geometry(k)


def test_plain_voxelize_is_differentiable():
    """On the CPU the plain version carries gradients to the vertices (the
    kernels are forward only)."""
    verts = t(_verts(1, 50)).requires_grad_(True)
    vol = kv.voxelize_semantic(verts, t(RNG.rand(50, 3).astype(np.float32)),
                               res=16)
    vol.sum().backward()
    assert verts.grad is not None and bool(torch.isfinite(verts.grad).all())


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        kv.voxel_splat(torch.zeros(10, 3), torch.zeros(10, 3), 8)
    with pytest.raises(ValueError):
        kv.voxel_splat(torch.zeros(1, 10, 3), torch.zeros(9, 3), 8)
    with pytest.raises(ValueError):
        kv.box_smooth3d(torch.zeros(1, 8, 8, 4), 3)


def test_grid_sample_3d_matches_jax():
    from icon_tpu.ops.grid_sample import grid_sample_3d as jgs
    from icon_tpu.ops.grid_sample import index as jindex
    from icon_tpu_torch.ops.grid_sample import grid_sample_3d, index
    vol = RNG.randn(2, 6, 7, 8, 5).astype(np.float32)
    xyz = RNG.uniform(-1.3, 1.3, (2, 200, 3)).astype(np.float32)
    xyz[0, :4] = [[1, 1, 1], [-1, -1, -1], [1.6, 0, 0], [0, -2.5, 0]]
    want = np.asarray(jgs(jnp.asarray(vol), jnp.asarray(xyz)))
    got = grid_sample_3d(t(vol), t(xyz))
    assert got.shape == (2, 200, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(np.abs(got.numpy()[0, 2:4]).max()) == 0.0
    np.testing.assert_array_equal(index(t(vol), t(xyz)).numpy(), got.numpy())
    img = RNG.randn(2, 9, 10, 4).astype(np.float32)
    np.testing.assert_allclose(
        index(t(img), t(xyz[..., :2])).numpy(),
        np.asarray(jindex(jnp.asarray(img), jnp.asarray(xyz[..., :2]))),
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        index(t(img), t(xyz[..., :1]))
