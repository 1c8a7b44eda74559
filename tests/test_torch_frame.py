"""Port parity, the slice as a whole: icon_tpu_torch.recon.frame (the
serving frame of bench.py) against the same composition in the JAX package,
with the same weights and batch, at image 64^2 with a subdiv-3 body and
res 128 (levels 33, 65, 129: one refined level, then interpolation).

Per-level counts and faces must be identical, vertices agree to the wire's
u8 fraction step; the raw net
occupancy at the level-0 points agrees to 1e-4 (the bar of the network
parity tests). The JAX frame's kNN is approx_max_k; on the CPU it returns
the exact top-k that the port computes, which the first test checks at the
full body's size."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (icon_cfg, init_jax_icon, port_cfg,
                                port_state, t)

from icon_tpu.utils.synthetic import synthetic_body, synthetic_icon_batch

RES = 128


def test_cpu_approx_max_k_is_exact_top_k():
    from icon_tpu.ops.sdf_fast import _nearest_vertices
    v, _ = synthetic_body(subdiv=5)
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    a = _nearest_vertices(jnp.asarray(pts), jnp.asarray(v), k=2, approx=True)
    e = _nearest_vertices(jnp.asarray(pts), jnp.asarray(v), k=2,
                          approx=False)
    assert len(v) == 10242
    np.testing.assert_array_equal(np.asarray(a), np.asarray(e))


def _jax_frame(cfg, jnet, variables, batch, res):
    """bench.py:137-226 at a small size: (compute features, query_fn,
    columns, engine, marcher)."""
    from icon_tpu.ops.sdf_fast import (build_column_bins,
                                       build_crossing_columns_blocked,
                                       build_vertex_face_table)
    from icon_tpu.recon.engine import ReconEngine, reconstruction_resolutions
    from icon_tpu.recon.marching import AutoMarcher
    from icon_tpu.utils.synthetic import clothed_human_occ

    b = {k: jnp.asarray(v) for k, v in batch.items()}
    eng = ReconEngine(reconstruction_resolutions(res), faster=True,
                      auto_budget=True, auto_headroom=1.3)
    smpl = {k: b[k] for k in ("smpl_verts", "smpl_faces", "smpl_cmap",
                              "smpl_vis")}
    smpl["smpl_vf_table"] = jnp.asarray(build_vertex_face_table(
        batch["smpl_faces"], batch["smpl_verts"].shape[1]))
    res1 = res + 1
    col_x = np.linspace(-1.0, 1.0, res1, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, res1, dtype=np.float32)
    cb, cm, tids = build_column_bins(batch["smpl_verts"][0],
                                     batch["smpl_faces"], col_x, col_y,
                                     compact=True)
    smpl["smpl_cross_meta"] = jnp.asarray(
        [-1.0, 1.0, (res1 - 1) / 2.0, (res1 - 1) / -2.0, float(res1),
         float(res1)], jnp.float32)
    columns = jax.jit(lambda v: build_crossing_columns_blocked(
        v, smpl["smpl_faces"], jnp.asarray(cb), jnp.asarray(cm),
        jnp.asarray(col_x), jnp.asarray(col_y), tile_ids=jnp.asarray(tids)))
    features = jnet.apply(variables, {"normal_F": b["normal_F"],
                                      "normal_B": b["normal_B"]}, False,
                          method=jnet.filter)

    def net_occ(pts, cross_z):
        return jnet.apply(variables, features, pts, b["calib"],
                          dict(smpl, smpl_cross_z=cross_z), False,
                          method=jnet.query)[-1]

    def query_fn(pts, cross_z):
        return net_occ(pts, cross_z) * 1e-6 + clothed_human_occ(pts)[..., None]

    marcher = AutoMarcher(max_cells=1 << 18, max_tris=1 << 19,
                          max_verts=1 << 19, slice_one=True, codec="lattice")

    def frame():
        cz, _ = columns(b["smpl_verts"][0])
        occ, stats = eng(query_fn, jit_levels=True, query_args=(cz,))
        mesh = marcher(occ, coarse_occ=stats["coarse_occ"])
        return stats, marcher.unpack(marcher.pack(mesh)), net_occ, cz

    return frame


@pytest.fixture(scope="module")
def frames():
    from icon_tpu_torch.recon.frame import build_frame
    cfg = icon_cfg()
    jnet, variables = init_jax_icon(cfg, seed=1)
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=64, n_samples=64, subdiv=3)
    jframe = _jax_frame(cfg, jnet, variables, batch, RES)
    pframe = build_frame(port_cfg(cfg), port_state(variables), batch, RES,
                         "cpu")
    return jframe, pframe


def test_frame_parity(frames):
    jframe, pframe = frames
    for _ in range(2):          # the second frame runs autotuned buffers
        jstats, (jv, jf), net_occ, jcz = jframe()
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
    assert pframe.engine._bucket_used[1] < pframe.engine.budgets[0]

    # raw net occupancy (without the analytic field) at the level-0 points
    g = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([xx, yy, zz], -1).reshape(1, -1, 3) * \
        np.array([2, -2, 2], np.float32) + np.array([-1, 1, -1], np.float32)
    ref = np.asarray(net_occ(jnp.asarray(pts), jcz))
    cz, counts = pframe.columns()
    assert int(counts.max()) <= 32
    with torch.no_grad():
        feats = pframe.features()
        raw = pframe.net_occ(t(pts), cz, feats)
        occ = pframe.query_fn(t(pts), cz, feats)
    np.testing.assert_allclose(raw.numpy(), ref, rtol=0, atol=1e-4)
    assert float(raw.std()) > 0.0
    assert float((occ - raw * 1e-6).min()) >= 0.0


def test_query_with_and_without_body_normals(frames, monkeypatch):
    """The frame's prep fills ``smpl_normals`` once a frame; the query's
    body features and occupancy at the level-0 points are bit-equal to the
    same query without the key, where each call computes the normals."""
    from icon_tpu_torch.ops import sdf_fast
    from icon_tpu_torch.recon import frame as frame_mod
    _, pframe = frames
    seen, calls = [], sdf_fast.cal_sdf_batch_fast

    def spy(*args, **kw):
        out = calls(*args, **kw)
        seen.append((kw.get("normals"), out))
        return out

    monkeypatch.setattr(sdf_fast, "cal_sdf_batch_fast", spy)
    g = np.linspace(-1.0, 1.0, 33, dtype=np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    pts = t(np.stack([xx, -yy, zz], -1).reshape(1, -1, 3))
    cz, _ = pframe.columns()
    with torch.no_grad():
        feats = pframe.features()
        given = pframe.net_occ(pts, cz, feats)
        put = frame_mod.to_device
        monkeypatch.setattr(frame_mod, "to_device", lambda d, dev: {
            k: v for k, v in put(d, dev).items() if k != "smpl_normals"})
        computed = pframe.net_occ(pts, cz, feats)
    (normals, with_key), (none, without) = seen
    assert normals is not None and normals.shape[0] == 1 and \
        normals.shape[2] == 3
    assert none is None
    for a, b in zip(with_key, without):
        assert torch.equal(a, b)
    assert torch.equal(given, computed)
