"""Port parity, the PIFu and PaMIR priors: HGPIFuNet filter and query of
icon_tpu_torch against the flax modules with the same weights moved by
state_dict_from_flax (pifu, pamir; PaMIR's query from the raw voxel
vertices and from ``volume_features``), the volume encoder, the image
filter's options (``hg_down`` conv64 / conv128, norm ``none``,
``use_filter`` False), perspective projection, and a seeded
reference-layout ``pamir.ckpt`` through both packages' loaders. The
networks to 1e-4 (``tests/test_torch_models.py``'s ATOL: deep float32
stacks summed in another order), the projection to 1e-5. The demo's
``pamir_feats`` and the tetrahedral SMPL loader are pinned in
``tests/test_torch_copies.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (icon_cfg, init_jax_icon, port_cfg,
                                port_state, prior_cfg, t)

from icon_tpu_torch.models.hgpifu import HGPIFuNet, mlp_first_dim

ATOL = 1e-4
RNG = np.random.RandomState(5)


def _pair(cfg, seed: int = 0):
    jnet, variables = init_jax_icon(cfg, seed=seed)
    net = HGPIFuNet(port_cfg(cfg), normal_net=False)
    net.load_state_dict(port_state(variables))            # strict
    return jnet, variables, net.eval()


@pytest.fixture(scope="module", params=["pifu", "pamir"])
def prior_pair(request):
    return (request.param,) + _pair(prior_cfg(request.param))


def _maps(size: int = 32):
    return {k: RNG.randn(1, size, size, 3).astype(np.float32)
            for k in ("image", "normal_F", "normal_B")}


def _voxel_inputs(n: int = 300):
    """Projected and halved vertices in the middle of the volume (some
    outside it) and their codes."""
    vv = RNG.uniform(-0.6, 0.6, (1, n, 3)).astype(np.float32)
    vv[0, :10] *= 2.5
    return vv, RNG.rand(n, 3).astype(np.float32)


def test_prior_filter_and_query_parity(prior_pair):
    """filter() and query() for the prior at points inside and outside the
    box; PaMIR's query from the raw voxel vertices and codes equals its
    query from ``volume_features`` (computed once a body) exactly."""
    prior, jnet, variables, net = prior_pair
    maps = _maps()
    pts = RNG.uniform(-1.2, 1.2, (1, 400, 3)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)[None]
    jfeat = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                   maps.items()}, False, method=jnet.filter)
    jsmpl, smpl = None, None
    if prior == "pamir":
        vv, vc = _voxel_inputs()
        jsmpl = {"voxel_verts": jnp.asarray(vv),
                 "voxel_codes": jnp.asarray(vc)}
        smpl = {"voxel_verts": t(vv), "voxel_codes": t(vc)}
    ref = jnet.apply(variables, jfeat, jnp.asarray(pts), jnp.asarray(calib),
                     jsmpl, False, method=jnet.query)[-1]
    with torch.no_grad():
        feats = net.filter({k: t(v) for k, v in maps.items()})
        out = net.query(feats, t(pts), t(calib), smpl)[-1]
    assert feats[0].shape == (1, 8, 8, 6)
    np.testing.assert_allclose(feats[0].numpy(), np.asarray(jfeat[-1]),
                               rtol=0, atol=ATOL)
    assert out.shape == (1, 400, 1) and float(out.std()) > 0.01
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    outside = np.any(np.abs(pts[0]) >= 1.0, axis=-1)
    assert outside.any() and float(np.abs(out.numpy()[0, outside]).max()) == 0
    if prior == "pamir":
        with torch.no_grad():
            vol = net.volume_features(smpl["voxel_verts"],
                                      smpl["voxel_codes"])
            again = net.query(feats, t(pts), t(calib),
                              {"voxel_feats": vol})[-1]
        assert vol[0].shape == (1, 8, 8, 8, 8)
        np.testing.assert_array_equal(again.numpy(), out.numpy())


def test_mlp_input_widths():
    """The MLP's first width per prior: the image features and the body
    features (icon), the volume features (pamir) or z (pifu); the filter's
    input channels without the filter."""
    assert mlp_first_dim(port_cfg(prior_cfg("icon"))) == 6 + 7
    assert mlp_first_dim(port_cfg(prior_cfg("pamir", voxel_dim=32))) == 38
    assert mlp_first_dim(port_cfg(prior_cfg("pifu"))) == 7
    assert mlp_first_dim(port_cfg(prior_cfg("pifu", use_filter=False))) == 10
    assert mlp_first_dim(port_cfg(prior_cfg("icon", use_filter=False))) == 13


def test_volume_encoder_parity():
    """The volume encoder alone at 32^3 (two stride-2 dilated 5^3
    convolutions to 8^3, two residual stacks), every stack, with the flax
    weights and batch statistics carried by state_dict_from_flax."""
    from icon_tpu.models.volume_encoder import VolumeEncoder as JVE
    from icon_tpu_torch.models.volume_encoder import VolumeEncoder
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    from torch_port_helpers import _randomize
    vol = RNG.rand(1, 32, 32, 32, 3).astype(np.float32)
    jve = JVE(num_out=16, num_stacks=2)
    variables = jve.init(jax.random.PRNGKey(3), jnp.asarray(vol))
    variables = {k: _randomize(v, np.random.RandomState(8))
                 for k, v in variables.items()}
    ref = jve.apply(variables, jnp.asarray(vol), False)
    ve = VolumeEncoder(num_out=16, num_stacks=2)
    sd = state_dict_from_flax({"ve": variables["params"]},
                              {"ve": variables["batch_stats"]})
    ve.load_state_dict({k[len("ve."):]: t(v) for k, v in sd.items()})
    with torch.no_grad():
        outs = ve.eval()(t(vol).permute(0, 4, 1, 2, 3),
                         intermediate_output=True)
    assert len(outs) == len(ref) == 2
    for a, b in zip(outs, ref):
        assert a.shape == (1, 16, 8, 8, 8)
        np.testing.assert_allclose(a.permute(0, 2, 3, 4, 1).numpy(),
                                   np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("prior,use_filter,hg_down,norm", [
    ("icon", True, "conv64", "batch"),
    ("pifu", True, "conv128", "none"),
    ("icon", False, "ave_pool", "group"),
    ("pifu", False, "ave_pool", "group"),
])
def test_filter_options_parity(prior, use_filter, hg_down, norm):
    """``hg_down`` conv64 / conv128 (a ConvBlock to 64 or 128 channels,
    then the stride-2 ``down_conv2``), norm ``none`` and ``use_filter``
    False (the input channels themselves are the features): filter against
    JAX, and for pifu the query."""
    cfg = prior_cfg(prior, use_filter=use_filter, hg_down=hg_down,
                    norm=norm)
    jnet, variables, net = _pair(cfg, seed=2)
    keys = set(net.state_dict())
    assert ("F_filter.down_conv2.weight" in keys) == (hg_down != "ave_pool")
    assert any(k.startswith("F_filter.") for k in keys) == use_filter
    assert not any(".bn" in k for k in keys if k.startswith("F_filter.")) \
        or norm != "none"
    maps = _maps(32)
    jfeat = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                   maps.items()}, False, method=jnet.filter)
    pts = RNG.uniform(-1.1, 1.1, (1, 200, 3)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)[None]
    with torch.no_grad():
        feats = net.filter({k: t(v) for k, v in maps.items()})
    np.testing.assert_allclose(feats[0].numpy(), np.asarray(jfeat[-1]),
                               rtol=0, atol=ATOL)
    if prior == "pifu":
        ref = jnet.apply(variables, jfeat, jnp.asarray(pts),
                         jnp.asarray(calib), None, False,
                         method=jnet.query)[-1]
        with torch.no_grad():
            out = net.query(feats, t(pts), t(calib))[-1]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


def test_perspective_projection():
    """``project(mode="perspective")`` (x/z, y/z, z) against JAX, and the
    pifu query under a perspective config."""
    import dataclasses
    from icon_tpu.ops.projection import project as jproject
    from icon_tpu_torch.ops.projection import project
    pts = RNG.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    calib = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    calib[:, :3, :3] += 0.1 * RNG.randn(2, 3, 3).astype(np.float32)
    calib[:, 2, 3] = 3.0
    for mode in ("perspective", "orthogonal"):
        np.testing.assert_allclose(
            project(t(pts), t(calib), mode=mode).numpy(),
            np.asarray(jproject(jnp.asarray(pts), jnp.asarray(calib),
                                mode=mode)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        project(t(pts), t(calib), mode="fisheye")
    cfg = prior_cfg("pifu")
    cfg = cfg.replace(projection_mode="perspective")
    jnet, variables, net = _pair(cfg, seed=4)
    maps = _maps(32)
    jfeat = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                   maps.items()}, False, method=jnet.filter)
    ref = jnet.apply(variables, jfeat, jnp.asarray(pts[:1]),
                     jnp.asarray(calib[:1]), None, False,
                     method=jnet.query)[-1]
    with torch.no_grad():
        out = net.query(net.filter({k: t(v) for k, v in maps.items()}),
                        t(pts[:1]), t(calib[:1]))[-1]
    assert dataclasses.asdict(net.cfg)["projection_mode"] == "perspective"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_pamir_ckpt_loads_in_both_packages(tmp_path):
    """A seeded reference-layout ``pamir.ckpt`` (``netG.*`` with the volume
    encoder's dead modules, a ``netG.voxelization`` buffer and Lightning
    entries) loads strictly into the port (``checkpoint_state``), and
    through the JAX package's ``port_icon_checkpoint`` into a NaN-filled
    JAX tree, writing every leaf; both packages then hold the same
    tensors."""
    from icon_tpu.training.checkpoints import partial_warm_start
    from icon_tpu.utils.torch_port import (load_torch_state,
                                           port_icon_checkpoint)
    from icon_tpu_torch.apps.infer import checkpoint_state
    from icon_tpu_torch.recon.frame import seeded_state
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    from icon_tpu_torch.utils.synthetic import ve_dead_modules
    from torch_port_helpers import nan_variables, unwritten_leaves
    jcfg = prior_cfg("pamir")
    cfg = port_cfg(jcfg)
    state = seeded_state(cfg, 7)
    geo = {"netG." + k: v for k, v in state.items()}
    geo.update(ve_dead_modules(cfg, 7))
    geo["netG.voxelization.sigma"] = torch.ones(1)
    path = str(tmp_path / "pamir.ckpt")
    torch.save({"state_dict": geo, "epoch": 1}, path)
    got = checkpoint_state(seeded_state(cfg, 8), path)
    assert set(got) == set(state)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), k)
    torch.save({"state_dict": {k: v for k, v in geo.items()
                               if not k.startswith("netG.ve.res1.conv1")}},
               path)
    with pytest.raises(KeyError, match="lack"):
        checkpoint_state(seeded_state(cfg, 8), path)

    jnet, variables = init_jax_icon(jcfg)
    nan = nan_variables(variables)
    torch.save({"state_dict": geo}, path)
    params, stats, log = port_icon_checkpoint(
        nan["params"], icon_state=load_torch_state(path))
    assert any("skipped: unused torch module" in line for line in log)
    params = {k: v for k, v in params.items() if k != "normal_filter"}
    stats = partial_warm_start(nan["batch_stats"], stats)
    assert unwritten_leaves(params) == [] and unwritten_leaves(stats) == []
    want = state_dict_from_flax(params, stats)
    assert set(want) == set(state)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v, state[k].numpy(), k)


def test_icon_prior_keeps_its_body_features():
    """The icon prior still needs the fast body features; the other priors
    take none (pifu) or the voxel inputs (pamir) and build without a
    NotImplementedError."""
    cfg = port_cfg(icon_cfg())
    net = HGPIFuNet(cfg, normal_net=False).eval()
    feats = [torch.zeros(1, 16, 16, 12)]
    with pytest.raises(NotImplementedError, match="item 3"):
        net.query(feats, torch.zeros(1, 4, 3), torch.eye(4)[None],
                  {"smpl_verts": torch.zeros(1, 4, 3)})
    for prior in ("pifu", "pamir", "sdf"):
        net = HGPIFuNet(port_cfg(prior_cfg(prior)), normal_net=False)
        assert hasattr(net, "ve") == (prior == "pamir")
