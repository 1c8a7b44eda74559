"""Port parity, SMPL-local features: icon_tpu_torch.ops.sdf_fast against
icon_tpu.ops.sdf_fast on the tests/test_sdf_fast.py body. Host tables,
crossing counts and signs must be identical and crossing depths agree to
1e-6; sdf, normal and cmap agree to 1e-5 absolute; vis must be identical."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import body, lattice_columns, t

from icon_tpu.ops import sdf_fast as J
from icon_tpu_torch.ops import sdf_fast as P

RNG = np.random.RandomState(11)


def test_host_tables_identical():
    v, f, _, _, table = body(subdiv=3)
    np.testing.assert_array_equal(P.build_vertex_face_table(f, len(v)),
                                  table)
    for compact in (False, True):
        for res1 in (33, 65):
            col_x = np.linspace(-1.0, 1.0, res1, dtype=np.float32)
            col_y = np.linspace(1.0, -1.0, res1, dtype=np.float32)
            ref = J.build_column_bins(v, f, col_x, col_y, compact=compact)
            out = P.build_column_bins(v, f, col_x, col_y, compact=compact)
            assert len(ref) == len(out)
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("res1", [33, 65])
def test_crossing_columns_identical(res1):
    v, f, _, _, _ = body(subdiv=3)
    cb, cm, tids, col_x, col_y, _ = lattice_columns(v, f, res1)
    zr, cr = jax.jit(J.build_crossing_columns_blocked)(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(cb), jnp.asarray(cm),
        jnp.asarray(col_x), jnp.asarray(col_y), tile_ids=jnp.asarray(tids))
    z, c = P.build_crossing_columns_blocked(
        t(v), t(f, torch.int64), t(cb), t(cm), t(col_x), t(col_y),
        tile_ids=t(tids))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
    assert int(c.max()) > 0 and int(c.max()) <= 32
    # the same crossings (inf padding identical); each depth is a 3-term
    # weighted sum that XLA contracts into FMAs, so it may differ by an ulp
    np.testing.assert_array_equal(np.isinf(z.numpy()), np.isinf(zr))
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=0, atol=1e-6)


def _features(v, f, cmaps, vis, table, pts, res1=65):
    """Both packages' cal_sdf_batch_fast with crossing-column signs."""
    cb, cm, tids, col_x, col_y, meta = lattice_columns(v, f, res1)
    jcz, _ = J.build_crossing_columns_blocked(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(cb), jnp.asarray(cm),
        jnp.asarray(col_x), jnp.asarray(col_y), tile_ids=jnp.asarray(tids))
    ref = J.cal_sdf_batch_fast(
        jnp.asarray(v[None]), jnp.asarray(f), jnp.asarray(cmaps[None]),
        jnp.asarray(vis[None]), jnp.asarray(pts[None]), jnp.asarray(table),
        cross_z=jcz, cross_meta=jnp.asarray(meta))
    cz, _ = P.build_crossing_columns_blocked(
        t(v), t(f, torch.int64), t(cb), t(cm), t(col_x), t(col_y),
        tile_ids=t(tids))
    out = P.cal_sdf_batch_fast(
        t(v[None]), t(f, torch.int64), t(cmaps[None]), t(vis[None]),
        t(pts[None]), t(table, torch.int64), cross_z=cz, cross_meta=t(meta))
    return [np.asarray(r)[0] for r in ref], [o.numpy()[0] for o in out]


def test_point_body_features_cross_z_parity():
    v, f, cmaps, vis, table = body(subdiv=3)
    res1 = 65
    g = np.linspace(-1, 1, res1, dtype=np.float32)
    # lattice points of the engine's box (y flipped) near and away from the
    # body, plus off-lattice points that snap to their nearest column
    ijk = RNG.randint(0, res1, (1500, 3))
    lat = np.stack([g[ijk[:, 0]], -g[ijk[:, 1]], g[ijk[:, 2]]], -1)
    near = v[RNG.randint(0, len(v), 500)] + \
        0.02 * RNG.randn(500, 3).astype(np.float32)
    pts = np.concatenate([lat, near]).astype(np.float32)
    ref, out = _features(v, f, cmaps, vis, table, pts, res1)
    sdf_r, nrm_r, cmap_r, vis_r = ref
    sdf, nrm, cmap, vis_q = out
    # same sign everywhere, same distance to 1e-5
    np.testing.assert_array_equal(sdf > 0, sdf_r > 0)
    np.testing.assert_allclose(sdf, sdf_r, rtol=0, atol=1e-5)
    # the JAX default kNN is approx_max_k; on the CPU it returns exact
    # top-k, so candidates and the winning face agree
    np.testing.assert_allclose(nrm, nrm_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cmap, cmap_r, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(vis_q, vis_r)
    assert 0.05 < (sdf > 0).mean() < 0.95


def test_column_parity_inside_identical():
    v, f, _, _, _ = body(subdiv=3)
    cb, cm, tids, col_x, col_y, meta = lattice_columns(v, f, 33)
    cz, _ = P.build_crossing_columns_blocked(
        t(v), t(f, torch.int64), t(cb), t(cm), t(col_x), t(col_y), t(tids))
    pts = RNG.uniform(-1.1, 1.1, (4000, 3)).astype(np.float32)
    ref = J.column_parity_inside(jnp.asarray(pts), jnp.asarray(cz.numpy()),
                                 jnp.asarray(meta))
    got = P.column_parity_inside(t(pts), cz, t(meta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_unported_sign_paths_raise():
    """The sign paths once refused (no sign input, and winding clusters)
    now run and sign as the JAX package's: the pseudo-normal test and the
    clustered winding number, identical signs on the points whose closest
    face both packages pick (tests/test_torch_winding.py holds them to the
    JAX package in full)."""
    v, f, cmaps, vis, table = body(subdiv=1)
    pts = RNG.uniform(-0.6, 0.6, (300, 3)).astype(np.float32)
    cf, cm = J.build_winding_clusters(v, f, 16)
    from icon_tpu.ops import sdf as JS
    from icon_tpu_torch.ops import sdf as PS
    same = PS.point_mesh_dist_winding(t(pts), t(v[f]))[1].numpy() == \
        np.asarray(JS.point_mesh_dist_winding(jnp.asarray(pts),
                                              jnp.asarray(v[f]))[1])
    for jkw, pkw in (({}, {}),
                     ({"cluster_faces": jnp.asarray(cf),
                       "cluster_mask": jnp.asarray(cm)},
                      {"cluster_faces": t(cf), "cluster_mask": t(cm)})):
        ref = J.point_body_features(
            jnp.asarray(pts), jnp.asarray(v), jnp.asarray(f),
            jnp.asarray(table), jnp.asarray(cmaps), jnp.asarray(vis), **jkw)
        out = P.point_body_features(
            t(pts), t(v), t(f, torch.int64), t(table, torch.int64),
            t(cmaps), t(vis), **pkw)
        np.testing.assert_array_equal(out[0].numpy()[same] > 0,
                                      np.asarray(ref[0])[same] > 0)
        np.testing.assert_allclose(np.abs(out[0].numpy()),
                                   np.abs(np.asarray(ref[0])), rtol=0,
                                   atol=1e-5)
