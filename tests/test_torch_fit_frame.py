"""Port parity, the demo's fit frame: ``build_fit_frame`` against the same
composition of JAX functions (``apps/infer.py:121-292`` for the icon prior
with the item given: refine_smpl_live, filter, _icon_feats with the crossing
columns, the engine on bench.py's variant field, lattice marching, the mesh
in world coordinates, clean_mesh, remesh, refine_cloth, query_color), with
the same weights, body and item: image 64^2, the subdiv-3 synthetic SMPL-X,
a narrow NormalNet and MLP, 2 fit iterations, 1 cloth iteration, res 128
(levels 33, 65, 129: one refined level; at res 64 no level is refined).

Fit losses to 1e-4 relative and the fitted body to 1e-4; level counts and
the marched faces identical, their vertices to the wire's u8 fraction step
(1/255 of a voxel edge). The remesher is host numpy and pinned identical by
tests/test_torch_remesh.py, but its collapse order follows edge lengths, so
a vertex one u8 step apart changes its output: the JAX composition
continues from the port's marched mesh. From there the remeshed meshes are
identical, the cloth losses agree to 1e-4 relative, the refined vertices
to 1e-4 and the colours to 1e-4 where the visibility agrees. The recon
step's raw net occupancy (before the field) agrees to 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (init_jax_icon, normalnet_cfg, port_cfg,
                                port_state)

RES = 128
SIZE = 64
LOOP_SMPL, LOOP_CLOTH = 2, 1
WIRE_STEP = 2.0 / RES / 255 + 1e-6      # one u8 step of a voxel, in world


def _world(verts, R):
    half = (R - 1) / 2.0
    return ((verts + 1.0 - half) / half *
            np.array([1.0, -1.0, 1.0], np.float32)).astype(np.float32)


def _jax_fit_frame(jnet, variables, jbody, item):
    """The demo's per-image body in the JAX package, step by step."""
    from icon_tpu.apps.infer import _icon_feats
    from icon_tpu.infer.refine import refine_cloth, refine_smpl_live
    from icon_tpu.ops.remesh import remesh
    from icon_tpu.recon.engine import ReconEngine, reconstruction_resolutions
    from icon_tpu.recon.marching import AutoMarcher
    from icon_tpu.render.render import query_color
    from icon_tpu.utils.io import clean_mesh
    from icon_tpu.utils.synthetic import clothed_human_occ

    image = jnp.asarray(item["image"])
    smpl_verts, (nF, nB), losses, _, _ = refine_smpl_live(
        jbody, jbody.faces, image, item["init"],
        lambda t: jnet.apply(variables, t, False,
                             method=jnet.predict_normals),
        item["scale"], iters=LOOP_SMPL, size=SIZE,
        mask=jnp.asarray(item["mask"]))
    eng = ReconEngine(reconstruction_resolutions(RES), faster=True,
                      auto_budget=True, auto_headroom=1.3)
    calib = jnp.asarray(item["calib"])[None]

    def net_occ_of(verts, nF, nB):
        """The recon step's raw occupancy field for a fitted body and its
        NormalNet normals: filter, _icon_feats, query."""
        features = jnet.apply(variables, {"image": image[None],
                                          "normal_F": jnp.asarray(nF)[None],
                                          "normal_B": jnp.asarray(nB)[None]},
                              False, method=jnet.filter)
        smpl = _icon_feats(jnp.asarray(verts), jbody.faces, item["calib"],
                           lattice_res=eng.resolutions[-1])
        return lambda pts: jnet.apply(variables, features, pts, calib, smpl,
                                      False, method=jnet.query)[-1]

    net_occ = net_occ_of(smpl_verts, nF, nB)

    def query_fn(pts):                  # bench.py:295-309
        preds = net_occ(pts)
        n = (jnp.sin(pts[..., 0] * 6.1 + 0.9) *
             jnp.sin(pts[..., 1] * 5.3 + 2.0) *
             jnp.sin(pts[..., 2] * 6.7 + 4.2))[..., None]
        spurious = 0.8 * jnp.maximum(n - 0.72, 0.0) / 0.28
        return jnp.clip(preds * 1e-6 + clothed_human_occ(pts)[..., None] +
                        spurious, 0.0, 1.0)

    occ, stats = eng(query_fn, jit_levels=True)
    marcher = AutoMarcher(max_cells=1 << 18, max_tris=1 << 19,
                          max_verts=1 << 19, slice_one=True, codec="lattice")
    verts, faces = marcher.unpack(marcher.pack(
        marcher(occ, coarse_occ=stats["coarse_occ"])))
    verts, faces = clean_mesh(_world(verts, eng.resolutions[-1]), faces)

    def finish(verts, faces):
        """remesh, refine_cloth and query_color of a marched mesh."""
        rverts, rfaces = remesh(verts, faces)
        refined, closses = refine_cloth(rverts, rfaces, nF, nB,
                                        iters=LOOP_CLOTH, size=SIZE)
        colors = query_color(jnp.asarray(refined), jnp.asarray(rfaces),
                             image)
        return {"remeshed": (rverts, rfaces), "refined": refined,
                "cloth_losses": closses, "colors": np.asarray(colors)}

    return {"fit_losses": losses, "smpl_verts": smpl_verts,
            "normals": (nF, nB), "stats": stats, "recon": (verts, faces),
            "finish": finish, "net_occ_of": net_occ_of}


@pytest.fixture(scope="module")
def frames():
    from icon_tpu.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import build_fit_frame, variant_occ
    from icon_tpu_torch.utils.convert import body_model_from_jax
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    cfg = normalnet_cfg()
    jnet, variables = init_jax_icon(cfg, seed=4, normal_net=True)
    jbody = synthetic_smplx_model(subdiv=3)
    pbody = body_model_from_jax(jbody)
    item = synthetic_fit_item(pbody, SIZE, seed=3)
    want = _jax_fit_frame(jnet, variables, jbody, item)
    frame = build_fit_frame(port_cfg(cfg), port_state(variables), pbody,
                            RES, "cpu", loop_smpl=LOOP_SMPL,
                            loop_cloth=LOOP_CLOTH, field=variant_occ)
    got = frame.frame(item)
    want.update(want.pop("finish")(*got.recon))
    return got, want, frame, item


def test_fit_and_recon_parity(frames):
    got, want, _, _ = frames
    np.testing.assert_allclose(got.fit.losses, want["fit_losses"],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(got.fit.verts.numpy(), want["smpl_verts"],
                               rtol=0, atol=1e-4)
    for k in ("level1_points", "level1_overflow"):
        assert int(got.stats[k]) == int(want["stats"][k]), k
    assert int(got.stats["level1_points"]) > 1000
    (gv, gf), (wv, wf) = got.recon, want["recon"]
    assert len(gf) > 5000
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=WIRE_STEP)
    for g, w in zip(got.remeshed, want["remeshed"]):
        np.testing.assert_array_equal(g, w)
    assert len(got.remeshed[1]) != len(gf)


def test_recon_occupancy_parity(frames):
    """The recon step's own chain, before bench.py's field: the fitted
    NormalNet normals through ``filter``, the fitted body's prep and the
    query, as raw net occupancy at seeded points in the box and within a few
    cm of the fitted body, to 1e-4. The JAX chain takes the port's fitted
    body and normals: the body features interpolate the nearest face's
    normal, cmap and visibility at the point's unclamped plane projection,
    so they jump where two faces are equidistant (most points off the body
    are nearest an edge or a vertex, and a tie keeps the first face); the
    JAX package's own fit, 5e-7 from the port's, moves the raw occupancy
    by up to 0.6 at 8% of these points."""
    got, want, frame, item = frames
    for g, w in zip(got.fit.normals, want["normals"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)
    calib = torch.from_numpy(item["calib"])
    smpl, feats = frame.prep(torch.from_numpy(item["image"]), got.fit, calib)
    rng = np.random.RandomState(5)
    v_cal = smpl["smpl_verts"][0].numpy()
    pts = np.concatenate([
        rng.uniform(-1, 1, (2048, 3)),
        v_cal[rng.randint(0, len(v_cal), 2048)] +
        rng.normal(0, 0.02, (2048, 3))]).astype(np.float32)[None]
    with torch.no_grad():
        raw = frame.net_occ(torch.from_numpy(pts), smpl, feats, calib).numpy()
    ref = np.asarray(want["net_occ_of"](
        got.fit.verts.numpy(), *[n.numpy() for n in got.fit.normals])(
            jnp.asarray(pts)))
    assert raw.shape == ref.shape == (1, 4096, 1)
    assert raw.std() > 1e-3
    np.testing.assert_allclose(raw, ref, rtol=0, atol=1e-4)


def test_cloth_and_color_parity(frames):
    got, want, _, _ = frames
    assert len(got.cloth_losses) == LOOP_CLOTH
    np.testing.assert_allclose(got.cloth_losses, want["cloth_losses"],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(got.verts.numpy(), want["refined"], rtol=0,
                               atol=1e-4)
    assert got.faces.dtype == torch.int64
    np.testing.assert_array_equal(got.faces.numpy(), want["remeshed"][1])
    colors = got.colors.numpy()
    assert colors.shape == want["colors"].shape
    assert ((colors >= 0) & (colors <= 1)).all()
    # a vertex whose visibility flips takes the other colour source
    close = np.abs(colors - want["colors"]).max(axis=1) <= 1e-4
    assert close.mean() > 0.999, close.mean()
