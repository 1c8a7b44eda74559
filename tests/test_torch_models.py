"""Port parity, networks: ConvBlock, HGFilter, MLP and HGPIFuNet
filter/query of icon_tpu_torch against the flax modules, with the same
weights moved by state_dict_from_flax. Layers (one ConvBlock, the pool) to
1e-5 absolute, like the ops; HGFilter, MLP and filter/query to 1e-4, the bar
of the torch twins in tests/test_icon_ckpt_port.py (deep float32 conv
stacks summed in another order)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (body, icon_cfg, init_jax_icon,
                                lattice_columns, port_cfg, port_state, t)

from icon_tpu_torch.models.hgpifu import HGPIFuNet
from icon_tpu_torch.models.layers import ConvBlock, avg_pool2, make_norm
from icon_tpu_torch.models.mlp import MLP
from icon_tpu_torch.utils.convert import state_dict_from_flax

ATOL = 1e-4
RNG = np.random.RandomState(3)


@pytest.fixture(scope="module")
def icon_pair():
    cfg = icon_cfg()
    jnet, variables = init_jax_icon(cfg)
    net = HGPIFuNet(port_cfg(cfg), normal_net=False)     # flax init had the normals
    net.load_state_dict(port_state(variables))            # strict
    return cfg, jnet, variables, net.eval()


@pytest.mark.parametrize("norm,cin,cout", [("group", 64, 128),
                                           ("group", 128, 128),
                                           ("batch", 32, 64)])
def test_convblock_parity(norm, cin, cout):
    from icon_tpu.models.layers import ConvBlock as JConvBlock
    x = RNG.randn(2, 8, 8, cin).astype(np.float32)
    jm = JConvBlock(cin, cout, norm)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    if "batch_stats" in variables:
        variables = dict(variables)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(RNG.randn(*a.shape)).astype(np.float32) + 0.5,
            variables["batch_stats"])
    ref = jm.apply(variables, jnp.asarray(x))
    m = ConvBlock(cin, cout, norm)
    sd = state_dict_from_flax(variables["params"],
                              variables.get("batch_stats"))
    m.load_state_dict({k: t(v) for k, v in sd.items()})
    assert (m.downsample is None) == (cin == cout)
    with torch.no_grad():
        out = m.eval()(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # one block, not a deep stack: the ops-core bar of 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_layer_primitives():
    from icon_tpu.models.layers import avg_pool2 as javg
    x = RNG.randn(1, 6, 10, 3).astype(np.float32)
    np.testing.assert_allclose(
        avg_pool2(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(javg(jnp.asarray(x))), rtol=0, atol=1e-6)
    gn, bn = make_norm("group", 64), make_norm("batch", 16, dim=1)
    inst = make_norm("instance", 8)
    assert (gn.num_groups, gn.eps, bn.eps, inst.eps) == (32, 1e-5, 1e-5,
                                                         1e-5)
    assert not inst.affine
    assert isinstance(make_norm("none", 8), torch.nn.Identity)
    assert not list(make_norm("none", 8).parameters())
    with pytest.raises(ValueError):
        make_norm("layer", 8)


def test_state_dict_keys_match_reference_layout(icon_pair):
    _, _, variables, net = icon_pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(net.state_dict())
    for key in ("F_filter.m0.b1_2.conv1.weight",
                "F_filter.conv2.downsample.0.weight",
                "F_filter.conv2.downsample.2.weight",
                "F_filter.m1.b3_1.bn4.bias",
                "if_regressor.filters.0.weight",
                "if_regressor.norms.0.running_mean"):
        assert key in sd, key
    np.testing.assert_array_equal(sd["F_filter.conv2.bn4.weight"],
                                  sd["F_filter.conv2.downsample.0.weight"])


def test_hgfilter_and_filter_parity(icon_pair):
    _, jnet, variables, net = icon_pair
    nF = RNG.randn(1, 64, 64, 3).astype(np.float32)
    nB = RNG.randn(1, 64, 64, 3).astype(np.float32)
    ref = jnet.apply(variables, {"normal_F": jnp.asarray(nF),
                                 "normal_B": jnp.asarray(nB)}, False,
                     method=jnet.filter)
    with torch.no_grad():
        feats = net.filter({"normal_F": t(nF), "normal_B": t(nB)})
        stacks = net.F_filter(t(nF).permute(0, 3, 1, 2))
    assert feats[0].shape == (1, 16, 16, 12)
    np.testing.assert_allclose(feats[0].numpy(), np.asarray(ref[-1]),
                               rtol=0, atol=ATOL)
    # every stack of the hourglass, not only the last one filter keeps
    jstacks = jnet.apply(variables, jnp.asarray(nF), False,
                         method=lambda m, x, tr: m.F_filter(x, tr))
    assert len(stacks) == len(jstacks) == 2
    for a, b in zip(stacks, jstacks):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="normal_net=False"):
        net.filter({"image": t(nF)})


def test_mlp_parity(icon_pair):
    _, jnet, variables, net = icon_pair
    pf = RNG.randn(1, 200, 13).astype(np.float32)
    ref = jnet.apply(variables, jnp.asarray(pf), False,
                     method=lambda m, f, tr: m.if_regressor(f, tr))
    with torch.no_grad():
        out = net.if_regressor(t(pf))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_mlp_group_norm():
    from icon_tpu.models.mlp import MLP as JMLP
    ch = (13, 32, 32, 1)
    jm = JMLP(ch, res_layers=(1, 2), norm="group")
    pf = RNG.randn(2, 50, 13).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(pf))
    m = MLP(ch, res_layers=(1, 2), norm="group")
    sd = state_dict_from_flax({"if_regressor": variables["params"]})
    m.load_state_dict({k[len("if_regressor."):]: t(v)
                       for k, v in sd.items()})
    with torch.no_grad():
        out = m(t(pf))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(pf))),
                               rtol=0, atol=ATOL)


def test_query_parity(icon_pair):
    """filter() + query() with the fast SMPL features signed by crossing
    columns, the serving path's composition, and without them (the
    pseudo-normal sign)."""
    from icon_tpu.ops.sdf_fast import build_crossing_columns_blocked as jcols
    from icon_tpu_torch.ops.sdf_fast import build_crossing_columns_blocked
    _, jnet, variables, net = icon_pair
    v, f, cmaps, vis, table = body(subdiv=3)
    cb, cm, tids, col_x, col_y, meta = lattice_columns(v, f, 65)
    jcz, _ = jcols(jnp.asarray(v), jnp.asarray(f), jnp.asarray(cb),
                   jnp.asarray(cm), jnp.asarray(col_x), jnp.asarray(col_y),
                   tile_ids=jnp.asarray(tids))
    cz, _ = build_crossing_columns_blocked(t(v), t(f, torch.int64), t(cb),
                                           t(cm), t(col_x), t(col_y),
                                           tile_ids=t(tids))
    # lattice points (the engine's queries) plus some off the box
    g = np.linspace(-1, 1, 65, dtype=np.float32)
    ijk = RNG.randint(0, 65, (600, 3))
    pts = np.stack([g[ijk[:, 0]], -g[ijk[:, 1]], g[ijk[:, 2]]], -1)
    pts[:20, 0] = 1.05
    pts = pts[None].astype(np.float32)
    calib = np.eye(4, dtype=np.float32)[None]
    nF = RNG.randn(1, 64, 64, 3).astype(np.float32)
    nB = RNG.randn(1, 64, 64, 3).astype(np.float32)

    jfeat = jnet.apply(variables, {"normal_F": jnp.asarray(nF),
                                   "normal_B": jnp.asarray(nB)}, False,
                       method=jnet.filter)
    jsmpl = {"smpl_verts": jnp.asarray(v[None]),
             "smpl_faces": jnp.asarray(f),
             "smpl_cmap": jnp.asarray(cmaps[None]),
             "smpl_vis": jnp.asarray(vis[None]),
             "smpl_vf_table": jnp.asarray(table),
             "smpl_cross_z": jcz, "smpl_cross_meta": jnp.asarray(meta)}
    ref = jnet.apply(variables, jfeat, jnp.asarray(pts), jnp.asarray(calib),
                     jsmpl, False, method=jnet.query)[-1]
    smpl = {"smpl_verts": t(v[None]), "smpl_faces": t(f, torch.int64),
            "smpl_cmap": t(cmaps[None]), "smpl_vis": t(vis[None]),
            "smpl_vf_table": t(table, torch.int64), "smpl_cross_z": cz,
            "smpl_cross_meta": t(meta)}
    with torch.no_grad():
        feats = net.filter({"normal_F": t(nF), "normal_B": t(nB)})
        out = net.query(feats, t(pts), t(calib), smpl)[-1]
    assert out.shape == (1, 600, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert float(np.abs(out.numpy()[0, :20]).max()) == 0.0   # off the box
    # without the crossing depths both packages sign by the pseudo-normal
    # test: the same occupancy where both pick the same closest face
    from icon_tpu.ops import sdf as JS
    from icon_tpu_torch.ops import sdf as PS
    ref = jnet.apply(variables, jfeat, jnp.asarray(pts), jnp.asarray(calib),
                     {k: x for k, x in jsmpl.items() if k != "smpl_cross_z"},
                     False, method=jnet.query)[-1]
    with torch.no_grad():
        out = net.query(feats, t(pts), t(calib),
                        {k: x for k, x in smpl.items()
                         if k != "smpl_cross_z"})[-1]
    same = PS.point_mesh_dist_winding(t(pts[0]), t(v[f]))[1].numpy() == \
        np.asarray(JS.point_mesh_dist_winding(jnp.asarray(pts[0]),
                                              jnp.asarray(v[f]))[1])
    assert same.mean() > 0.75        # lattice points tie on the mirror body
    np.testing.assert_allclose(out.numpy()[0, same], np.asarray(ref)[0, same],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("prior", ["pifu", "pamir"])
def test_priors_build_and_run(prior):
    """The pifu and pamir priors build with the NormalNet and run filter
    (normals predicted from the renders) and query end to end: finite
    occupancy in [0, 1] inside the box, 0 outside; PaMIR's volume features
    are ``[B, voxel_res / 4, ..., voxel_dim]``."""
    cfg = icon_cfg()
    cfg = port_cfg(cfg.replace(net=dataclasses.replace(
        cfg.net, prior_type=prior, voxel_res=16, voxel_dim=4, ngf=4,
        n_downsampling=1, n_blocks=1,
        in_geo=(("image", 3), ("normal_F", 3), ("normal_B", 3)))))
    torch.manual_seed(0)
    net = HGPIFuNet(cfg).eval()
    assert hasattr(net, "ve") == (prior == "pamir")
    maps = {k: t(RNG.randn(1, 32, 32, 3).astype(np.float32))
            for k in ("image", "T_normal_F", "T_normal_B")}
    pts = t(RNG.uniform(-1.2, 1.2, (1, 64, 3)).astype(np.float32))
    with torch.no_grad():
        feats = net.filter(maps)
        smpl = None
        if prior == "pamir":
            vol = net.volume_features(
                t(RNG.uniform(-0.5, 0.5, (1, 40, 3)).astype(np.float32)),
                t(RNG.rand(40, 3).astype(np.float32)))
            assert vol[0].shape == (1, 4, 4, 4, 4)
            smpl = {"voxel_feats": vol}
        out = net.query(feats, pts, torch.eye(4)[None], smpl)[-1]
    assert feats[0].shape == (1, 8, 8, 6) and out.shape == (1, 64, 1)
    inside = (pts.abs() < 1).all(-1)[0]
    assert bool(((out >= 0) & (out <= 1)).all())
    assert float(out[0, ~inside].abs().max()) == 0.0
