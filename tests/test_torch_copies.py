"""The port's copies of framework-free code of the JAX package, pinned to
their originals: the config tree's field names and defaults, ``clean_mesh``,
the host lattice decoder and the synthetic body's arrays."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from torch_port_helpers import port_cfg, t

import icon_tpu.config as JC
import icon_tpu_torch.config as PC
from icon_tpu import native
from icon_tpu.recon import marching as JM
from icon_tpu.utils import io as JIO
from icon_tpu.utils import synthetic as JS
from icon_tpu_torch.recon import lattice_host as PH
from icon_tpu_torch.recon import marching as PM
from icon_tpu_torch.utils import io as PIO
from icon_tpu_torch.utils import synthetic as PS


@pytest.mark.parametrize("name", ["Config", "NetConfig", "DatasetConfig"])
def test_config_fields_and_defaults(name):
    jc, pc = getattr(JC, name), getattr(PC, name)
    jf, pf = dataclasses.fields(jc), dataclasses.fields(pc)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())


def test_port_cfg_keeps_every_field():
    from icon_tpu_torch.recon.frame import bench_config
    cfg = port_cfg(JC.Config(net=JC.NetConfig(ngf=8, in_geo=(("a", 3),))))
    assert isinstance(cfg, PC.Config) and isinstance(cfg.net, PC.NetConfig)
    assert cfg.net.ngf == 8 and cfg.net.in_geo_dim == 3
    assert dataclasses.asdict(port_cfg(JC.Config())) == \
        dataclasses.asdict(PC.Config())
    assert isinstance(bench_config(), PC.Config)


def test_clean_mesh_matches():
    rng = np.random.RandomState(0)
    v, f = JS.synthetic_body(subdiv=2)
    # three components: the body, a shifted copy, and a lone triangle
    verts = np.concatenate([v, v + 3.0, rng.randn(3, 3).astype(np.float32)])
    faces = np.concatenate([f, f[:40] + len(v),
                            np.array([[0, 1, 2]]) + 2 * len(v)])
    for args in ((verts, faces), (v, f)):
        pv, pf = PIO.clean_mesh(*args)
        jv, jf = JIO.clean_mesh(*args)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pf, jf)
    assert len(PIO.clean_mesh(verts, faces)[0]) == len(v)


@pytest.mark.parametrize("implicit", [False, True])
def test_lattice_decoder_matches(implicit):
    """The port's g++-built decoder and the JAX package's native one give
    the same mesh of one packed lattice, vertex for vertex."""
    assert native.available()
    n = 33
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2) + \
        0.08 * np.sin(7 * x) * np.sin(5 * y)
    occ = (1.0 / (1.0 + np.exp((r - 0.8) * 12))).astype(np.float32)
    D, H, W = occ.shape
    lat = PM.marching_lattice(t(occ), max_cells=1 << 14, max_verts=1 << 15)
    buf, nvb, ncb = PM.pack_lattice(lat, implicit_eid=implicit)
    host = buf.numpy()
    pv, pf, pinfo = PH.lattice_decode(host, nvb, ncb, H, W, implicit)
    jv, jf, jinfo = native.lattice_decode(
        host, nvb, ncb, H, W, *JM._host_tables_flat(), implicit=implicit)
    assert len(pf) > 1000
    np.testing.assert_array_equal(pinfo, jinfo)
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pv, jv)
    dv, df = PH.decode_lattice((buf, nvb, ncb), H, W)
    np.testing.assert_array_equal(df, jf.astype(np.int64))


def test_lattice_decoder_rejects_malformed_sizes():
    with pytest.raises(ValueError, match="malformed"):
        PH.lattice_decode(np.zeros(4, np.int32), 0, 4, 8, 8, False)


@pytest.mark.parametrize("subdiv", [0, 2, 3])
def test_synthetic_body_arrays_match(subdiv):
    for a, b in zip(PS.synthetic_body(subdiv), JS.synthetic_body(subdiv)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PS.icosphere(subdiv, 0.7), JS.icosphere(subdiv, 0.7)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_skeleton_matches():
    rng = np.random.RandomState(1)
    for pose in (None, (rng.randn(24, 3) * 0.3).astype(np.float32)):
        pj, jj = PS.posed_skeleton(pose), JS.posed_skeleton(pose)
        np.testing.assert_array_equal(pj, jj)
        for a, b in zip(PS._capsule_segments(pj), JS._capsule_segments(jj)):
            np.testing.assert_array_equal(a, b)
    for name in ("SMPL_PARENTS", "REST_JOINTS", "THUMAN2_0525_POSE"):
        np.testing.assert_array_equal(getattr(PS, name), getattr(JS, name))
    assert PS.BONE_CAPSULES == JS.BONE_CAPSULES
    # the torch field on the copied skeleton equals the JAX field
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    np.testing.assert_allclose(
        PS.clothed_human_occ(t(pts)).numpy(),
        np.asarray(JS.clothed_human_occ(jnp.asarray(pts))), atol=1e-5)
