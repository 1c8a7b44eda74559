"""Port parity, the gradient of PaMIR's semantic voxelization:
``kernels/voxelize.py:voxelize_semantic`` under a gradient (on CPU tensors
its ``autograd.Function`` runs the plain forward and the plain backward
twins, ``ops/voxelize.py:box_smooth3d_bwd_plain`` and
``voxel_splat_bwd_plain``) against ``jax.grad`` of the JAX package's
``voxelize_semantic`` at res 16, B = 2: codes ``[V, 3]`` and ``[B, V, 3]``,
boxes k = 1, 3 and 4 (the adjoint of an even box is the mirrored box),
vertices outside the volume, vertices on grid planes (``d|u|/du`` is +1 at
``u = 0`` in JAX, 0 in torch's ``abs``) and a voxel whose smoothed weight is
exactly float32(1e-3) (``maximum`` splits the gradient at the tie). Both
gradients to 1e-5 of the largest gradient (``VOXEL_GRAD_RTOL``): the same
float32 terms, summed in another order (JAX divides each window's
gradient by k before it sums it). Then PaMIR's ``HGPIFuNet.query``
gradient with respect to the voxel vertices and codes against the flax
module's, through the weight converter, to ``QUERY_GRAD_RTOL``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (init_jax_icon, port_cfg, port_state,
                                prior_cfg, t)

from icon_tpu_torch.kernels import voxelize as kv
from icon_tpu_torch.ops import voxelize as pv

RES = 16
VOXEL_GRAD_RTOL = 1e-5
# the query's gradient passes the MLP, grid_sample_3d and the volume
# encoder's convolutions, each summed in another order than XLA's: 1e-4 of
# the largest gradient (tests/test_torch_priors.py's ATOL for the networks'
# outputs)
QUERY_GRAD_RTOL = 1e-4
# isolated vertices (z on the grid plane g = 0, so their dz = 1 corners
# weigh 0) whose corner (0, 1, 0) weighs (1 - frac_x) frac_y at res 16:
# with k = 1, exactly float32(1e-3) at the voxel (x, y, z) = (8, 1, 0).
# Under a 3-box no weight ties in both packages: the port divides each
# pass by 3 (0.027 and 0.027000003 give the tie), XLA multiplies by
# float32(1/3) (0.026999997 and 0.026999999 give it). So k = 3 pins the
# near sides: a corner weight of 0.027000004 makes the voxel (7, 2, 0), the
# only non-zero voxel in its box, 0.0010000002 in both, and 0.026999995
# makes it 0.0009999998 (the port) and 0.0009999999 (JAX)
TIE_VERTEX = {
    (1, "tie"): ((0.094270885, -0.99983186, -1.0), (8, 1, 0), 0.001),
    (3, "above"): ((0.09402878, -0.99547046, -1.0), (7, 2, 0), 0.0010000002),
    (3, "below"): ((0.09404142, -0.9954699, -1.0), (7, 2, 0), 0.0009999998)}


def _grid_plane_values(rng, n):
    """``n`` float32 coordinates whose voxel coordinate ``(v + 1) * 0.5 *
    (RES - 1)`` is an integer (the end planes -1 and 1 among them)."""
    out = [np.float32(-1.0), np.float32(1.0)]
    while len(out) < n:
        i = rng.randint(1, RES - 1)
        v = np.float32(2.0 * i / (RES - 1) - 1.0)
        for _ in range(64):
            g = np.float32(np.float32(np.float32(v + np.float32(1.0)) *
                                      np.float32(0.5)) * np.float32(RES - 1))
            if g == i:
                out.append(v)
                break
            v = np.nextafter(v, np.float32(np.inf if g < i else -np.inf),
                             dtype=np.float32)
    return np.array(out, np.float32)


def _inputs(seed, batched, outside=True, tie=None):
    rng = np.random.RandomState(seed)
    B, V = 2, 160
    verts = rng.uniform(-0.7, 0.7, (B, V, 3)).astype(np.float32)
    if outside:                  # corners or whole vertices outside
        verts[:, :16] = np.abs(verts[:, :16]) * 1.6
        verts[1, 16] = [1.0, -1.0, 0.999]
    planes = _grid_plane_values(rng, 12)
    for b in range(B):           # vertices on grid planes: 2 or 3 axes
        for j in range(24):
            axes = rng.permutation(3)[:2 + j % 2]
            verts[b, 20 + j, axes] = rng.choice(planes, len(axes))
    if tie is not None:
        verts[0, -1] = TIE_VERTEX[tie][0]
    codes = rng.rand(*((B, V, 3) if batched else (V, 3))).astype(np.float32)
    return verts, codes


def _jax_grads(verts, codes, k, r):
    from icon_tpu.ops.voxelize import voxelize_semantic as jvox

    def loss(v, c):
        return jnp.sum(jvox(v, c, res=RES, smooth_kernel=k) * r)
    gv, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(verts),
                                            jnp.asarray(codes))
    return np.asarray(gv), np.asarray(gc)


def _port_grads(verts, codes, k, r):
    v = t(verts).requires_grad_(True)
    c = t(codes).requires_grad_(True)
    out = kv.voxelize_semantic(v, c, res=RES, smooth_kernel=k)
    (out * t(r)).sum().backward()
    return out.detach(), v.grad.numpy(), c.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=VOXEL_GRAD_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("batched,k,tie", [
    (False, 3, None), (True, 4, None), (True, 2, None),
    (False, 1, "tie"), (True, 1, "tie"), (True, 3, "above"),
    (False, 3, "below")])
def test_voxelize_grad_matches_jax(batched, k, tie):
    verts, codes = _inputs(k + 10 * batched, batched,
                           tie=None if tie is None else (k, tie))
    r = np.random.RandomState(k).randn(2, RES, RES, RES, 3).astype(
        np.float32)
    want_v, want_c = _jax_grads(verts, codes, k, r)
    before = (kv.launches_splat_bwd, kv.launches_smooth_bwd)
    out, got_v, got_c = _port_grads(verts, codes, k, r)
    assert (kv.launches_splat_bwd, kv.launches_smooth_bwd) == before
    assert got_v.shape == verts.shape and got_c.shape == codes.shape
    assert float(np.abs(got_v).max()) > 1.0
    _close(got_v, want_v)
    _close(got_c, want_c)
    # the forward under a gradient is the plain version's
    np.testing.assert_array_equal(
        out.numpy(), pv.voxelize_semantic(t(verts), t(codes), res=RES,
                                          smooth_kernel=k).numpy())
    if tie is None:
        return
    # the smoothed weight is the tie (or its near side) exactly ...
    acc = pv.voxel_splat_plain(t(verts), t(codes), RES)
    _, weight = pv.box_smooth3d_plain(acc.view(2, RES, RES, RES, 4), k,
                                      keep_weight=True)
    _, (x, y, z), w = TIE_VERTEX[(k, tie)]
    assert weight[0, z, y, x].item() == np.float32(w)
    if tie == "tie":
        # ... and torch's rule there (all of the gradient to the weight)
        # moves the tie vertex's gradient off JAX's
        v = t(verts).requires_grad_(True)
        out = pv.voxelize_semantic(v, t(codes), res=RES, smooth_kernel=k)
        (out * t(r)).sum().backward()
        gap = float(np.abs(v.grad.numpy()[0, -1] - want_v[0, -1]).max())
        assert gap > 100 * VOXEL_GRAD_RTOL * float(np.abs(want_v).max())


def test_grid_plane_vertices_take_jax_abs_rule():
    """A vertex on grid planes gets JAX's gradient, not the one torch's
    autograd of the plain forward gives (``abs'(0) = 0`` there)."""
    verts, codes = _inputs(3, False, outside=False)
    r = np.random.RandomState(4).randn(2, RES, RES, RES, 3).astype(
        np.float32)
    want_v, _ = _jax_grads(verts, codes, 3, r)
    _, got_v, _ = _port_grads(verts, codes, 3, r)
    v = t(verts).requires_grad_(True)
    (pv.voxelize_semantic(v, t(codes), res=RES, smooth_kernel=3) *
     t(r)).sum().backward()
    scale = float(np.abs(want_v).max())
    rows = slice(20, 44)
    assert float(np.abs(v.grad.numpy()[:, rows] - want_v[:, rows]).max()) \
        > 100 * VOXEL_GRAD_RTOL * scale
    _close(got_v, want_v)


def test_codes_gradient_only_where_asked():
    """The Function returns the codes' gradient only when the codes need
    one; the vertices' is then unchanged, and without any gradient asked
    the wrapper runs the forward as before."""
    verts, codes = _inputs(5, False)
    r = torch.from_numpy(np.random.RandomState(5).randn(
        2, RES, RES, RES, 3).astype(np.float32))
    v = t(verts).requires_grad_(True)
    c = t(codes)
    (kv.voxelize_semantic(v, c, res=RES, smooth_kernel=3) * r).sum() \
        .backward()
    assert c.grad is None
    _, both_v, _ = _port_grads(verts, codes, 3, r.numpy())
    np.testing.assert_array_equal(v.grad.numpy(), both_v)
    with torch.no_grad():
        out = kv.voxelize_semantic(v, c, res=RES, smooth_kernel=3)
    assert out.grad_fn is None


def test_backward_twins_shapes_and_refusals():
    """The backward entry on CPU tensors is the plain twins, launches
    nothing, and refuses mismatched shapes."""
    verts, codes = _inputs(6, True)
    rng = np.random.RandomState(6)
    out = torch.from_numpy(rng.rand(2, RES, RES, RES, 3).astype(np.float32))
    w = torch.from_numpy(rng.rand(2, RES, RES, RES).astype(np.float32))
    g_out = torch.from_numpy(rng.randn(2, RES, RES, RES, 3)
                             .astype(np.float32))
    before = (kv.launches_splat_bwd, kv.launches_smooth_bwd)
    gv, gc = kv._voxelize_bwd(t(verts), t(codes), g_out, out, w, RES, 4)
    g_acc = pv.box_smooth3d_bwd_plain(g_out, out, w, 4).view(2, -1, 4)
    want = pv.voxel_splat_bwd_plain(t(verts), t(codes), g_acc, RES)
    assert torch.equal(gv, want[0]) and torch.equal(gc, want[1])
    assert kv._voxelize_bwd(t(verts), t(codes), g_out, out, w, RES, 4,
                            codes_grad=False)[1] is None
    assert (kv.launches_splat_bwd, kv.launches_smooth_bwd) == before
    with pytest.raises(ValueError):
        kv._voxelize_bwd(t(verts), t(codes), g_out, out, w[..., :-1], RES, 4)
    with pytest.raises(ValueError):
        kv._voxelize_bwd(t(verts)[:1], t(codes)[:1], g_out, out, w, RES, 4)


@pytest.mark.parametrize("k", [3, 4])
def test_box_backward_is_the_adjoint(k):
    """<box(x), y> = <x, box_adjoint(y)> for the smooth's linear part (the
    weight channel held away from the floor): the mirrored window, checked
    in float64."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.rand(1, 6, 7, 5, 4))
    x[..., 3] += 50.0                  # every smoothed weight above 1e-3
    out, w = pv.box_smooth3d_plain(x, k, keep_weight=True)
    y = torch.from_numpy(rng.randn(1, 6, 7, 5, 3))
    xr = x.clone().requires_grad_(True)
    (pv.box_smooth3d_plain(xr, k) * y).sum().backward()
    got = pv.box_smooth3d_bwd_plain(y, out, w, k)
    np.testing.assert_allclose(got.numpy(), xr.grad.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.fixture(scope="module")
def pamir_pair():
    cfg = prior_cfg("pamir")
    jnet, variables = init_jax_icon(cfg, seed=2)
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    net = HGPIFuNet(port_cfg(cfg), normal_net=False)
    net.load_state_dict(port_state(variables))
    return jnet, variables, net.eval()


def test_pamir_query_grad_matches_jax(pamir_pair):
    """The gradient of PaMIR's summed occupancy with respect to the voxel
    vertices and codes (``HGPIFuNet.query`` from the raw voxel inputs, in
    eval mode) is non-zero and equals JAX's."""
    jnet, variables, net = pamir_pair
    rng = np.random.RandomState(9)
    maps = {k: rng.randn(1, 32, 32, 3).astype(np.float32)
            for k in ("image", "normal_F", "normal_B")}
    pts = rng.uniform(-0.9, 0.9, (1, 500, 3)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)[None]
    vv = rng.uniform(-0.6, 0.6, (1, 300, 3)).astype(np.float32)
    vv[0, :10] *= 2.5
    vc = rng.rand(300, 3).astype(np.float32)
    jfeat = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                   maps.items()}, False, method=jnet.filter)

    def loss(v, c):
        out = jnet.apply(variables, jfeat, jnp.asarray(pts),
                         jnp.asarray(calib),
                         {"voxel_verts": v, "voxel_codes": c}, False,
                         method=jnet.query)[-1]
        return jnp.sum(out)
    want_v, want_c = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(vv), jnp.asarray(vc)))
    with torch.no_grad():
        feats = net.filter({k: t(v) for k, v in maps.items()})
    v, c = t(vv).requires_grad_(True), t(vc).requires_grad_(True)
    net.query(feats, t(pts), t(calib),
              {"voxel_verts": v, "voxel_codes": c})[-1].sum().backward()
    assert float(np.abs(v.grad.numpy()).max()) > 1e-3
    assert float(np.abs(c.grad.numpy()).max()) > 1e-3
    for got, want in ((v.grad.numpy(), want_v), (c.grad.numpy(), want_c)):
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=QUERY_GRAD_RTOL * float(np.abs(want).max()))
