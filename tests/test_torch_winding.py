"""Port parity, the winding-cluster and pseudo-normal signs and the
unblocked crossing columns: icon_tpu_torch.ops.sdf_fast
(``build_winding_clusters``, ``fast_winding`` through the plain version of
``kernels/winding.py``, ``point_body_features`` and
``cal_sdf_batch_fast`` with clusters or no sign input,
``build_crossing_columns``) and ``HGPIFuNet.query`` with ``smpl_clusters``
against the JAX package on the same seeded inputs.

Tolerances: the clusters identical. Winding numbers to 1e-4 absolute, and
to 1e-5 at 99% of the points: both sum up to m M exact solid angles of
float32 atan2s that round otherwise in XLA than in PyTorch, and the two
packages' cluster tables (float32 sums in another order, centroids within
~1e-7) can rank two clusters of nearly equal gap the other way, which
moves one cluster between the exact and the dipole set and shows its
dipole error (measured up to 4.6e-5). Signs identical wherever |w - 0.5|
> 1e-4. The body features as ``tests/test_torch_sdf_fast.py`` holds them
(1e-5 absolute, vis identical), on the points where both packages pick
the same closest face (ties, Queue C "the body features jump"). Crossing
counts identical and depths to 1e-6 (XLA contracts the 3-term weighted
sums into FMAs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import body, t

from icon_tpu.ops import sdf as JS
from icon_tpu.ops import sdf_fast as J
from icon_tpu_torch.ops import sdf as PS
from icon_tpu_torch.ops import sdf_fast as P

W_ATOL = 1e-4
W_TYPICAL = 1e-5
SIGN_MARGIN = 1e-4


def _posed_body(subdiv=4, pose_scale=0.1, seed=5):
    """JAX's tests/test_sdf_fast.py:_posed_body from the port's own
    synthetic SMPL-X (array-identical to the JAX one): (verts, faces,
    the seeded generator after the pose)."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    model = synthetic_smplx_model(subdiv=subdiv)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        v, _ = model(betas=torch.from_numpy(
            rng.randn(1, 10).astype(np.float32) * 0.3),
            body_pose=torch.from_numpy(
                rng.randn(1, 63).astype(np.float32) * pose_scale))
    return v[0].numpy(), np.asarray(model.faces, np.int64), rng


def _points(v, n, seed):
    """Half near the surface (vertices jittered), half in the box."""
    rng = np.random.RandomState(seed)
    near = v[rng.randint(0, len(v), n // 2)] + \
        rng.normal(scale=0.03, size=(n // 2, 3))
    box = rng.uniform(v.min(0) - 0.1, v.max(0) + 0.1, (n - n // 2, 3))
    return np.concatenate([near, box]).astype(np.float32)


def _attrs(v):
    cmaps = ((v - v.min(0)) / (v.max(0) - v.min(0))).astype(np.float32)
    vis = (v[:, 2:3] > 0).astype(np.float32)
    return cmaps, vis


def _windings_agree(w, wj):
    d = np.abs(w - wj)
    assert d.max() <= W_ATOL, d.max()
    assert np.mean(d <= W_TYPICAL) >= 0.99
    clear = np.abs(wj - 0.5) > SIGN_MARGIN
    np.testing.assert_array_equal(w[clear] > 0.5, wj[clear] > 0.5)


@pytest.mark.parametrize("subdiv,n_clusters", [(2, 256), (3, 256), (4, 256),
                                               (3, 100), (2, 7)])
def test_build_winding_clusters_identical(subdiv, n_clusters):
    v, f, _, _, _ = body(subdiv=subdiv)
    for a, b in zip(P.build_winding_clusters(v, f, n_clusters),
                    J.build_winding_clusters(v, f, n_clusters)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,m_near", [("sphere body", 16),
                                         ("posed body", 16),
                                         ("posed body", 4)])
def test_fast_winding_matches(name, m_near):
    if name == "sphere body":
        v, f, _, _, _ = body(subdiv=3)
    else:
        v, f, _ = _posed_body(subdiv=3)
    cf, cm = J.build_winding_clusters(v, f)
    pts = _points(v, 3000, seed=1)
    wj = np.asarray(J.fast_winding(
        *(jnp.asarray(x) for x in (pts, v, f, cf, cm)), m_near=m_near))
    w = P.fast_winding(t(pts), t(v), t(f, torch.int64), t(cf), t(cm),
                       m_near=m_near, chunk=1000).numpy()
    _windings_agree(w, wj)
    assert 0.05 < (wj > 0.5).mean() < 0.95


def _features(v, f, pts, jkw, pkw, k=2):
    cmaps, vis = _attrs(v)
    table = J.build_vertex_face_table(f, len(v))
    ref = J.point_body_features(
        jnp.asarray(pts), jnp.asarray(v), jnp.asarray(f), jnp.asarray(table),
        jnp.asarray(cmaps), jnp.asarray(vis), k=k, **jkw)
    out = P.point_body_features(
        t(pts), t(v), t(f, torch.int64), t(table, torch.int64), t(cmaps),
        t(vis), k=k, **pkw)
    return [o.numpy() for o in out], [np.asarray(r) for r in ref]


def _same_face(pts, v, f):
    """Points whose closest face both packages' exact oracles agree on."""
    return PS.point_mesh_dist_winding(t(pts), t(v[f]))[1].numpy() == \
        np.asarray(JS.point_mesh_dist_winding(jnp.asarray(pts),
                                              jnp.asarray(v[f]))[1])


def _features_agree(out, ref, same):
    np.testing.assert_allclose(np.abs(out[0]), np.abs(ref[0]), rtol=0,
                               atol=1e-5)
    for a, b in zip(out[1:3], ref[1:3]):
        np.testing.assert_allclose(a[same], b[same], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[3][same], ref[3][same])


def test_point_body_features_with_clusters():
    """The winding-cluster sign: identical signs away from |w - 0.5| <=
    1e-4 (none of these points is that close), features as the
    crossing-column sign's."""
    v, f, _ = _posed_body(subdiv=3)
    cf, cm = J.build_winding_clusters(v, f)
    pts = _points(v, 2000, seed=2)
    out, ref = _features(
        v, f, pts, {"cluster_faces": jnp.asarray(cf),
                    "cluster_mask": jnp.asarray(cm)},
        {"cluster_faces": t(cf), "cluster_mask": t(cm)})
    wj = np.asarray(J.fast_winding(*(jnp.asarray(x) for x in
                                     (pts, v, f, cf, cm))))
    assert np.abs(wj - 0.5).min() > SIGN_MARGIN
    np.testing.assert_array_equal(out[0] > 0, ref[0] > 0)
    _features_agree(out, ref, _same_face(pts, v, f))


@pytest.mark.parametrize("name", ["sphere body", "posed body"])
def test_point_body_features_pseudo_normal_sign(name):
    """No sign input: the pseudo-normal sign at the clamped closest-point
    barycentrics, identical to the JAX package's on every point whose
    closest face both pick."""
    if name == "sphere body":
        v, f, _, _, _ = body(subdiv=3)
    else:
        v, f, _ = _posed_body(subdiv=3, pose_scale=0.25)
    pts = _points(v, 2000, seed=3)
    out, ref = _features(v, f, pts, {}, {})
    same = _same_face(pts, v, f)
    assert same.mean() > 0.8
    np.testing.assert_array_equal(out[0][same] > 0, ref[0][same] > 0)
    _features_agree(out, ref, same)


def test_cal_sdf_batch_fast_per_item_clusters():
    """Two posed bodies, each with its own clusters ([B, K, M]) against the
    JAX package's batched call, and shared clusters ([K, M])."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    model = synthetic_smplx_model(subdiv=3)
    rng = np.random.RandomState(8)
    with torch.no_grad():
        vb, _ = model(body_pose=torch.from_numpy(
            rng.randn(2, 63).astype(np.float32) * 0.2))
    vb = vb.numpy()
    f = np.asarray(model.faces, np.int64)
    table = J.build_vertex_face_table(f, vb.shape[1])
    cl = [J.build_winding_clusters(v, f) for v in vb]
    cf = np.stack([c[0] for c in cl])
    cm = np.stack([c[1] for c in cl])
    attrs = [_attrs(v) for v in vb]
    cmaps = np.stack([a[0] for a in attrs])
    vis = np.stack([a[1] for a in attrs])
    pts = np.stack([_points(v, 800, seed=9 + i) for i, v in enumerate(vb)])
    for per_item in (True, False):
        c_f, c_m = (cf, cm) if per_item else (cf[0], cm[0])
        ref = J.cal_sdf_batch_fast(
            jnp.asarray(vb), jnp.asarray(f), jnp.asarray(cmaps),
            jnp.asarray(vis), jnp.asarray(pts), jnp.asarray(table),
            cluster_faces=jnp.asarray(c_f), cluster_mask=jnp.asarray(c_m))
        out = P.cal_sdf_batch_fast(
            t(vb), t(f), t(cmaps), t(vis), t(pts), t(table, torch.int64),
            cluster_faces=t(c_f), cluster_mask=t(c_m))
        for b in range(2):
            w = np.asarray(J.fast_winding(*(jnp.asarray(x) for x in (
                pts[b], vb[b], f, c_f if c_f.ndim == 2 else c_f[b],
                c_m if c_m.ndim == 2 else c_m[b]))))
            clear = np.abs(w - 0.5) > SIGN_MARGIN
            np.testing.assert_array_equal(out[0].numpy()[b, clear, 0] > 0,
                                          np.asarray(ref[0])[b, clear, 0] > 0)
            np.testing.assert_allclose(np.abs(out[0].numpy()[b]),
                                       np.abs(np.asarray(ref[0])[b]),
                                       rtol=0, atol=1e-5)


def test_query_with_winding_clusters():
    """HGPIFuNet.query with ``smpl_clusters`` and ``smpl_cluster_mask``
    (and the fast features' vertex-face table) in both packages: the same
    occupancy to 1e-4 wherever both pick the same closest face."""
    from torch_port_helpers import icon_cfg, init_jax_icon, port_cfg, \
        port_state
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    cfg = icon_cfg()
    jnet, variables = init_jax_icon(cfg)
    net = HGPIFuNet(port_cfg(cfg), normal_net=False).eval()
    net.load_state_dict(port_state(variables))
    v, f, _ = _posed_body(subdiv=3)
    cmaps, vis = _attrs(v)
    cf, cm = J.build_winding_clusters(v, f)
    rng = np.random.RandomState(6)
    maps = {k: rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
            for k in ("normal_F", "normal_B")}
    pts = _points(v, 400, seed=7)[None]
    smpl = {"smpl_verts": v[None], "smpl_faces": f,
            "smpl_cmap": cmaps[None], "smpl_vis": vis[None],
            "smpl_vf_table": J.build_vertex_face_table(f, len(v)),
            "smpl_clusters": cf, "smpl_cluster_mask": cm}
    jfeat = jnet.apply(variables, {k: jnp.asarray(x) for k, x in
                                   maps.items()}, False, method=jnet.filter)
    ref = jnet.apply(variables, jfeat, jnp.asarray(pts),
                     jnp.eye(4)[None], {k: jnp.asarray(x) for k, x in
                                        smpl.items()}, False,
                     method=jnet.query)[-1]
    with torch.no_grad():
        feats = net.filter({k: t(x) for k, x in maps.items()})
        out = net.query(feats, t(pts), torch.eye(4)[None],
                        {k: t(x) for k, x in smpl.items()})[-1]
    same = _same_face(pts[0], v, f)
    assert same.mean() > 0.9
    np.testing.assert_allclose(out.numpy()[0, same], np.asarray(ref)[0, same],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("res1,n_tiles", [(33, 32), (65, 128)])
def test_build_crossing_columns_identical(res1, n_tiles):
    """The unblocked crossing columns over the ray bins, on the engine's
    column lattice."""
    v, f, _, _, _ = body(subdiv=3)
    bins, grid = J.build_ray_bins(v, f, n_tiles=n_tiles)
    col_x = np.linspace(-1.0, 1.0, res1, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, res1, dtype=np.float32)
    zr, cr = jax.jit(J.build_crossing_columns)(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(bins),
        jnp.asarray(grid), jnp.asarray(col_x), jnp.asarray(col_y))
    z, c = P.build_crossing_columns(t(v), t(f, torch.int64), t(bins),
                                    t(grid), t(col_x), t(col_y), chunk=1000)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
    assert int(c.max()) > 0
    np.testing.assert_array_equal(np.isinf(z.numpy()), np.isinf(zr))
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=0, atol=1e-6)


def test_pseudo_normal_sign_against_winding_on_sphere():
    """The port's mirror of JAX's tests/test_sdf_fast.py:63: on a sphere
    the pseudo-normal sign equals the exact winding sign away from 1% of
    the surface."""
    from icon_tpu_torch.utils.synthetic import icosphere
    v, f = icosphere(subdiv=3, radius=0.6)
    table = P.build_vertex_face_table(f, len(v))
    pts = (np.random.RandomState(11).rand(800, 3) * 2 - 1).astype(np.float32)
    sdf, _, _, _ = P.point_body_features(
        t(pts), t(v), t(f, torch.int64), t(table, torch.int64),
        torch.zeros(len(v), 3), torch.zeros(len(v), 1))
    inside_w = PS.check_inside(t(v[None]), t(f, torch.int64),
                               t(pts[None]))[0].numpy()
    far = np.abs(np.linalg.norm(pts, axis=1) - 0.6) > 0.01
    np.testing.assert_array_equal(sdf.numpy()[far, 0] > 0, inside_w[far])


def test_winding_sign_matches_exact_winding():
    """The port's mirror of JAX's tests/test_sdf_fast.py:144: on a posed
    body the clustered winding sign equals the dense exact winding's on
    near-surface samples."""
    vv, ff, rng = _posed_body(subdiv=4, pose_scale=0.1)
    cmaps, vis = _attrs(vv)
    table = P.build_vertex_face_table(ff, len(vv))
    cf, cm = P.build_winding_clusters(vv, ff)
    pts = vv[rng.randint(0, len(vv), 800)] + \
        rng.normal(scale=0.05, size=(800, 3)).astype(np.float32)
    sdf, _, _, _ = P.point_body_features(
        t(pts), t(vv), t(ff), t(table, torch.int64), t(cmaps), t(vis),
        cluster_faces=t(cf), cluster_mask=t(cm))
    _, _, w = PS.point_mesh_dist_winding(t(pts), t(vv[ff]))
    np.testing.assert_array_equal(sdf.numpy()[:, 0] > 0, w.numpy() > 0.5)
