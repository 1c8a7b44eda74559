"""Port parity, the NormalNet serving frame: the per-body prep
(icon_tpu_torch.recon.frame.icon_feats and crossing_columns) against the
demo's own ``apps/infer.py:_icon_feats``, and
``build_normalnet_frame`` against the same composition in the JAX package
(the body's normal renders, predict_normals, filter, _icon_feats, then
bench.py's variant field through the engine and the lattice marcher), with
the same weights and batch: image 64^2, subdiv-3 body, a narrow NormalNet
and MLP, res 128 (levels 33, 65, 129: one refined level).

Visibility, vertex-face table and the crossing depths' counts are
identical, cmap and depths to 1e-6; per-level counts and faces identical,
vertices to the wire's u8 fraction step; the raw net occupancy at the
level-0 points to 1e-4, the bar of the network parity tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (init_jax_icon, normalnet_cfg, port_cfg,
                                port_state, t)

from icon_tpu.utils.synthetic import synthetic_icon_batch

RES = 128


def _calib():
    """A scaled, shifted orthographic calib, so projection matters."""
    c = np.eye(4, dtype=np.float32) * 0.92
    c[3, 3] = 1.0
    c[:3, 3] = [0.03, -0.02, 0.01]
    return c


@pytest.fixture(scope="module")
def body():
    batch = synthetic_icon_batch(np.random.RandomState(4), B=1,
                                 image_size=64, n_samples=8, subdiv=3)
    return batch["smpl_verts"][0], batch["smpl_faces"]


def test_icon_feats_parity(body):
    from icon_tpu.apps.infer import _icon_feats
    from icon_tpu_torch.ops.projection import project
    from icon_tpu_torch.recon.frame import (body_bins, crossing_columns,
                                            icon_feats)
    v, f = body
    calib = _calib()
    ref = _icon_feats(jnp.asarray(v), f, calib, lattice_res=RES + 1)
    v_cal = project(t(v)[None], t(calib)[None])[0]
    bins = body_bins(v_cal.numpy(), f, RES + 1, "cpu")
    smpl = icon_feats(t(v), t(f, torch.int64), t(calib), bins)
    cross_z, counts = crossing_columns(smpl, bins)
    for k in ("smpl_verts", "smpl_cmap"):
        np.testing.assert_allclose(smpl[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)
    for k in ("smpl_vis", "smpl_vf_table", "smpl_faces", "smpl_cross_meta"):
        np.testing.assert_array_equal(smpl[k].numpy(), np.asarray(ref[k]))
    assert 0.3 < float(smpl["smpl_vis"].mean()) < 0.7
    rz = np.asarray(ref["smpl_cross_z"])
    np.testing.assert_array_equal(np.isinf(cross_z.numpy()), np.isinf(rz))
    fin = np.isfinite(rz)
    np.testing.assert_allclose(cross_z.numpy()[fin], rz[fin], rtol=0,
                               atol=1e-6)
    assert fin.any() and int(counts.max()) <= 32


def _jax_frame(jnet, variables, batch, res):
    """The NormalNet frame in the JAX package: (stats, (verts, faces),
    net_occ, smpl_feat) of one frame."""
    from icon_tpu.apps.infer import _icon_feats
    from icon_tpu.recon.engine import ReconEngine, reconstruction_resolutions
    from icon_tpu.recon.marching import AutoMarcher
    from icon_tpu.render.render import render_normal
    from icon_tpu.utils.synthetic import clothed_human_occ

    b = {k: jnp.asarray(v) for k, v in batch.items()}
    eng = ReconEngine(reconstruction_resolutions(res), faster=True,
                      auto_budget=True, auto_headroom=1.3)
    marcher = AutoMarcher(max_cells=1 << 18, max_tris=1 << 19,
                          max_verts=1 << 19, slice_one=True, codec="lattice")
    verts, faces = b["smpl_verts"][0], b["smpl_faces"]
    size = batch["image"].shape[1]
    t_f, _ = render_normal(verts, faces, size=size)
    t_b, _ = render_normal(verts, faces, size=size, azimuth=180.0)
    nml_f, nml_b = jnet.apply(variables, {"image": b["image"],
                                          "T_normal_F": t_f[None],
                                          "T_normal_B": t_b[None]}, False,
                              method=jnet.predict_normals)
    features = jnet.apply(variables, {"image": b["image"], "normal_F": nml_f,
                                      "normal_B": nml_b}, False,
                          method=jnet.filter)
    smpl = _icon_feats(verts, batch["smpl_faces"], batch["calib"][0],
                       lattice_res=eng.resolutions[-1])

    def net_occ(pts):
        return jnet.apply(variables, features, pts, b["calib"], smpl, False,
                          method=jnet.query)[-1]

    def query_fn(pts):                  # bench.py:295-309
        n = (jnp.sin(pts[..., 0] * 6.1 + 0.9) *
             jnp.sin(pts[..., 1] * 5.3 + 2.0) *
             jnp.sin(pts[..., 2] * 6.7 + 4.2))[..., None]
        spurious = 0.8 * jnp.maximum(n - 0.72, 0.0) / 0.28
        return jnp.clip(net_occ(pts) * 1e-6 + clothed_human_occ(pts)[..., None]
                        + spurious, 0.0, 1.0)

    occ, stats = eng(query_fn, jit_levels=True)
    mesh = marcher(occ, coarse_occ=stats["coarse_occ"])
    return stats, marcher.unpack(marcher.pack(mesh)), net_occ, (nml_f, nml_b)


@pytest.fixture(scope="module")
def frames():
    from icon_tpu_torch.recon.frame import build_normalnet_frame
    cfg = normalnet_cfg()
    jnet, variables = init_jax_icon(cfg, seed=3, normal_net=True)
    batch = synthetic_icon_batch(np.random.RandomState(5), B=1,
                                 image_size=64, n_samples=8, subdiv=3)
    batch["image"][0, :6] = 0.0         # background rows
    jout = _jax_frame(jnet, variables, batch, RES)
    pframe = build_normalnet_frame(port_cfg(cfg), port_state(variables),
                                   batch, RES, "cpu")
    return jout, pframe


def test_normalnet_frame_parity(frames):
    (jstats, (jv, jf), net_occ, jnormals), pframe = frames
    for _ in range(2):          # the second frame runs autotuned buffers
        stats, _, verts, faces = pframe.frame()
        for k in ("level1_points", "level1_overflow"):
            assert int(stats[k]) == int(jstats[k]), k
        assert int(stats["level1_points"]) > 1000
        assert len(faces) > 10000
        np.testing.assert_array_equal(faces, jf)
        # the wire carries each vertex's fraction along its edge as u8; a
        # fraction within float32 noise of a rounding midpoint may land one
        # step (1/255 of a voxel edge) apart
        np.testing.assert_allclose(verts, jv, rtol=0, atol=1 / 255 + 1e-6)
        assert (np.abs(verts - jv) > 1e-5).mean() < 1e-3

    with torch.no_grad():
        normals = pframe.normals(*pframe.render())
        feats = pframe.features(*normals)
        smpl = pframe.body()
        smpl["smpl_cross_z"], _ = pframe.columns(smpl)
        g = torch.linspace(0.0, 1.0, pframe.engine.resolutions[0])
        zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
        pts = torch.stack([xx, yy, zz], -1).reshape(1, -1, 3) * \
            torch.tensor([2.0, -2.0, 2.0]) + torch.tensor([-1.0, 1.0, -1.0])
        raw = pframe.net_occ(pts, smpl, feats)
    for got, want in zip(normals, jnormals):
        assert float(got.abs().sum()) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    ref = np.asarray(net_occ(jnp.asarray(pts.numpy())))
    np.testing.assert_allclose(raw.numpy(), ref, rtol=0, atol=1e-4)
    assert float(raw.std()) > 0.0


def test_normalnet_serve_matches_the_jax_frame(frames):
    """The frame's 2-deep serving loop gives the JAX frame's counts and
    mesh on every frame of an unchanged input."""
    (jstats, (jv, jf), _, _), pframe = frames
    served = pframe.serve(3)
    assert len(served) == 3
    for stats, verts, faces in served:
        for k in ("level1_points", "level1_overflow"):
            assert int(stats[k]) == int(jstats[k]), k
        np.testing.assert_array_equal(faces, jf)
        np.testing.assert_allclose(verts, jv, rtol=0, atol=1 / 255 + 1e-6)
        assert (np.abs(verts - jv) > 1e-5).mean() < 1e-3
