"""Port parity, the exact signs: icon_tpu_torch's ray-bin sign
(``ops/sdf_fast.py``: ``build_ray_bins``, ``ray_parity_inside_np``,
``ray_parity_inside``), its copy of the fast winding numbers
(``ops/winding_np.py``) and the exact oracle (``ops/sdf.py``:
``point_mesh_dist_winding``, ``cal_sdf_batch``, ``check_inside``) against
the JAX package on the same seeded points.

Tolerances: every sign, bin table and inside test identical; the closest
face identical but at ties (two faces as close to 1e-6, where the float32
sums of the two packages may rank them either way; the features of such a
point come from different faces, Queue C "the body features jump");
winding numbers equal to 1e-12 (the same float64 numpy); distances to
1e-6 and the interpolated features to 1e-5 absolute (float32 sums in a
different order); the body features signed by ray bins or known signs as
``tests/test_torch_sdf_fast.py`` holds those signed by crossing columns."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import body, t

from icon_tpu.ops import sdf as JS
from icon_tpu.ops import sdf_fast as J
from icon_tpu.ops import winding_np as JW
from icon_tpu_torch.ops import sdf as PS
from icon_tpu_torch.ops import sdf_fast as P
from icon_tpu_torch.ops import winding_np as PW


def _posed_body():
    """The SMPL-X stand-in of the dataset fixture in a seeded pose (its
    arms and legs near one another), with the batch's cmap and vis."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    model = synthetic_smplx_model(subdiv=3)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        v, _ = model(body_pose=torch.from_numpy(
            rng.randn(1, 63).astype(np.float32) * 0.3))
    v = v[0].numpy()
    f = np.asarray(model.faces, np.int64)
    cmaps = ((v - v.min(0)) / (v.max(0) - v.min(0))).astype(np.float32)
    vis = (v[:, 2:3] > 0).astype(np.float32)
    return v, f, cmaps, vis, P.build_vertex_face_table(f, len(v))


def _points(v, n, seed):
    """Half near the surface (vertices jittered), half in the box."""
    rng = np.random.RandomState(seed)
    near = v[rng.randint(0, len(v), n // 2)] + \
        rng.normal(scale=0.02, size=(n // 2, 3))
    lo, hi = v.min(0) - 0.1, v.max(0) + 0.1
    box = rng.uniform(lo, hi, (n - n // 2, 3))
    return np.concatenate([near, box]).astype(np.float32)


BODIES = {"sphere body": lambda: body(subdiv=3), "posed SMPL-X": _posed_body}


@pytest.mark.parametrize("name", list(BODIES))
@pytest.mark.parametrize("cap", [None, 128])
def test_ray_bins_identical(name, cap):
    v, f = BODIES[name]()[:2]
    for n_tiles in (32, 128):
        ref = J.build_ray_bins(v, f, n_tiles=n_tiles, cap=cap)
        out = P.build_ray_bins(v, f, n_tiles=n_tiles, cap=cap)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="overflow"):
        P.build_ray_bins(v, f, n_tiles=4, cap=8)


@pytest.mark.parametrize("name", list(BODIES))
def test_ray_parity_identical(name):
    """The host parity (the dataset's labels), the device parity (the
    evaluation's queries) and the JAX package's both: identical."""
    v, f = BODIES[name]()[:2]
    pts = _points(v, 6000, seed=1)
    ref_np = J.ray_parity_inside_np(pts, v, f)
    np.testing.assert_array_equal(P.ray_parity_inside_np(pts, v, f), ref_np)
    bins, grid = J.build_ray_bins(v, f)
    ref = J.ray_parity_inside(jnp.asarray(pts), jnp.asarray(v),
                              jnp.asarray(f), jnp.asarray(bins),
                              jnp.asarray(grid))
    got = P.ray_parity_inside(t(pts), t(v), t(f, torch.int64), t(bins),
                              t(grid), chunk=1000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.2 < got.float().mean() < 0.8
    # the parity is the winding number's inside test on a closed body
    assert (got.numpy() == JW.winding_inside(pts, v, f)).mean() > 0.999


@pytest.mark.parametrize("name", list(BODIES))
def test_winding_copy_matches(name):
    v, f = BODIES[name]()[:2]
    pts = _points(v, 3000, seed=2)
    ref = JW.FastWinding(v, f).winding(pts)
    out = PW.FastWinding(v, f).winding(pts)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(PW.winding_inside(pts, v, f),
                                  JW.winding_inside(pts, v, f))
    np.testing.assert_allclose(PW.solid_angles(pts[:64], v[f]),
                               JW.solid_angles(pts[:64], v[f]), atol=1e-12)


@pytest.mark.parametrize("name", list(BODIES))
def test_exact_oracle_matches(name):
    v, f, cmaps, vis, _ = BODIES[name]()
    pts = _points(v, 1500, seed=3)
    tris = v[f]
    d2r, idxr, wr = JS.point_mesh_dist_winding(jnp.asarray(pts),
                                               jnp.asarray(tris), chunk=256,
                                               point_chunk=512)
    d2, idx, w = PS.point_mesh_dist_winding(t(pts), t(tris), chunk=256,
                                            point_chunk=512)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2r), rtol=0,
                               atol=1e-6)
    same = idx.numpy() == np.asarray(idxr)
    assert same.mean() > 0.9
    # where the faces differ, the port's face is as close as the JAX one's
    d_jax_face = np.array([float(PS.point_mesh_dist_winding(
        t(p[None]), t(tris[j][None]))[0]) for p, j in
        zip(pts[~same], np.asarray(idxr)[~same])])
    np.testing.assert_allclose(d_jax_face, d2.numpy()[~same], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(wr), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        PS.check_inside(t(v[None]), t(f, torch.int64), t(pts[None])).numpy(),
        np.asarray(JS.check_inside(jnp.asarray(v[None]), jnp.asarray(f),
                                   jnp.asarray(pts[None]))))
    ref = JS.cal_sdf_batch(jnp.asarray(v[None]), jnp.asarray(f),
                           jnp.asarray(cmaps[None]), jnp.asarray(vis[None]),
                           jnp.asarray(pts[None]))
    out = PS.cal_sdf_batch(t(v[None]), t(f, torch.int64), t(cmaps[None]),
                           t(vis[None]), t(pts[None]))
    sdf, sdf_r = out[0].numpy(), np.asarray(ref[0])
    np.testing.assert_array_equal(np.sign(sdf), np.sign(sdf_r))
    np.testing.assert_allclose(sdf, sdf_r, rtol=0, atol=1e-6)
    for a, b in zip(out[1:3], ref[1:3]):
        np.testing.assert_allclose(a.numpy()[0, same], np.asarray(b)[0, same],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[3].numpy()[0, same],
                                  np.asarray(ref[3])[0, same])


@pytest.mark.parametrize("sign", ["ray_bins", "known_inside"])
def test_body_features_signed_like_the_jax_package(sign):
    """cal_sdf_batch_fast with ray bins (the evaluation's sign) and with
    the dataset's known signs (the training's): identical signs, features
    as the crossing-column sign's."""
    v, f, cmaps, vis, table = _posed_body()
    pts = _points(v, 2000, seed=5)
    bins, grid = J.build_ray_bins(v, f)
    inside = J.ray_parity_inside_np(pts, v, f)
    jkw = {"ray_bins": {"ray_bins": jnp.asarray(bins),
                        "ray_grid": jnp.asarray(grid)},
           "known_inside": {"known_inside": jnp.asarray(inside[None])}}[sign]
    pkw = {k: t(np.asarray(x)) for k, x in jkw.items()}
    ref = J.cal_sdf_batch_fast(
        jnp.asarray(v[None]), jnp.asarray(f), jnp.asarray(cmaps[None]),
        jnp.asarray(vis[None]), jnp.asarray(pts[None]), jnp.asarray(table),
        **jkw)
    out = P.cal_sdf_batch_fast(t(v[None]), t(f, torch.int64),
                               t(cmaps[None]), t(vis[None]), t(pts[None]),
                               t(table, torch.int64), **pkw)
    sdf, sdf_r = out[0].numpy(), np.asarray(ref[0])
    np.testing.assert_array_equal(np.sign(sdf), np.sign(sdf_r))
    np.testing.assert_array_equal(sdf[0, :, 0] > 0, inside)
    for a, b in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


def test_query_without_the_table_takes_the_exact_oracle():
    """HGPIFuNet.query with the body but no vertex-face table: the exact
    cal_sdf_batch in both packages, the same occupancy to 1e-4 wherever
    both packages pick the same closest face (the identity calib keeps the
    points as they are)."""
    from torch_port_helpers import icon_cfg, init_jax_icon, port_cfg, \
        port_state
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    cfg = icon_cfg()
    jnet, variables = init_jax_icon(cfg)
    net = HGPIFuNet(port_cfg(cfg), normal_net=False).eval()
    net.load_state_dict(port_state(variables))
    v, f, cmaps, vis, _ = BODIES["sphere body"]()
    rng = np.random.RandomState(6)
    maps = {k: rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
            for k in ("normal_F", "normal_B")}
    pts = _points(v, 400, seed=7)[None]
    smpl = {"smpl_verts": v[None], "smpl_faces": f,
            "smpl_cmap": cmaps[None], "smpl_vis": vis[None]}
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
    same = PS.point_mesh_dist_winding(t(pts[0]), t(v[f]))[1].numpy() == \
        np.asarray(JS.point_mesh_dist_winding(jnp.asarray(pts[0]),
                                              jnp.asarray(v[f]))[1])
    assert same.mean() > 0.9
    np.testing.assert_allclose(out.numpy()[0, same], np.asarray(ref)[0, same],
                               rtol=0, atol=1e-4)
