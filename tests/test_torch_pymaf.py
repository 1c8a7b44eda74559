"""Port parity, PyMAF (``icon_tpu_torch.models.pymaf``): the geometry
functions, the backbone and every iteration of the network against the JAX
package at a small width (backbone width 16, layers 1-1-1-1, the 24-joint
synthetic SMPL at subdiv 3), with the JAX variables (BatchNorm statistics,
scales and biases randomized) carried over by ``pymaf_state_from_flax``.
Tolerance 1e-4 absolute throughout. Then the checkpoint layout: the port's
state-dict keys are the published checkpoint's (``tests/torch_twins/
pymaf_twin.py``), and a reference-layout ``.pt`` loads into both packages
to the same forward."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import pymaf_pair, t

WIDTH, LAYERS, SUBDIV = 16, (1, 1, 1, 1), 3
ATOL = 1e-4


def test_geometry_matches():
    from icon_tpu.models.pymaf import geometry as J
    from icon_tpu_torch.models.pymaf import geometry as P
    rng = np.random.RandomState(0)
    x6 = rng.randn(5, 24 * 6).astype(np.float32)
    R = P.rot6d_to_rotmat(t(x6))
    np.testing.assert_allclose(R.numpy(), np.asarray(J.rot6d_to_rotmat(
        jnp.asarray(x6))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        P.rotmat_to_angle_axis(R).numpy(),
        np.asarray(J.rotmat_to_angle_axis(jnp.asarray(R.numpy()))),
        rtol=0, atol=1e-5)
    np.testing.assert_array_equal(P.identity_rot6d(4).numpy(),
                                  np.asarray(J.identity_rot6d(4)))
    pts = rng.randn(2, 50, 3).astype(np.float32) * 0.5
    cam = np.array([[0.9, 0.1, -0.2], [1.2, -0.05, 0.3]], np.float32)
    np.testing.assert_allclose(
        P.weak_perspective_projection(t(pts), t(cam)).numpy(),
        np.asarray(J.weak_perspective_projection(jnp.asarray(pts),
                                                 jnp.asarray(cam))),
        rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, variables, the port's net with their weights, input
    batch, (JAX body, port body, dmap))."""
    jnet, variables, pnet, extra = pymaf_pair(WIDTH, LAYERS, SUBDIV)
    x = np.random.RandomState(1).randn(2, 224, 224, 3).astype(np.float32)
    return jnet, variables, pnet, x, extra


@pytest.fixture(scope="module")
def outputs(nets):
    jnet, variables, pnet, x, _ = nets
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = pnet(t(x))
    return got, want


def test_backbone_matches(nets):
    from icon_tpu.models.pymaf.resnet import ResNetBackbone
    jnet, variables, pnet, x, _ = nets
    sub = {k: v["feature_extractor"] for k, v in variables.items()}
    s_j, g_j = ResNetBackbone(layers=LAYERS, width=WIDTH).apply(
        sub, jnp.asarray(x), False)
    with torch.no_grad():
        s_p, g_p = pnet.feature_extractor(t(x).permute(0, 3, 1, 2))
    assert s_p.shape == (2, 32 * WIDTH, 7, 7)
    np.testing.assert_allclose(s_p.permute(0, 2, 3, 1).numpy(),
                               np.asarray(s_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("it", [0, 1, 2, 3])
def test_every_iteration_matches(outputs, it):
    """Iteration 0 is the mean-parameter body, 1 samples the grid, 2-3 the
    projected vertices of the previous estimate."""
    got, want = outputs
    assert len(got["smpl_out"]) == len(want["smpl_out"]) == 4
    g, w = got["smpl_out"][it], want["smpl_out"][it]
    for k in ("pred_pose", "pred_shape", "pred_cam", "rotmat", "verts",
              "theta", "kp_2d"):
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
    if it:        # the regressor moved the estimate off the mean
        assert float((g["pred_pose"] - got["smpl_out"][0]["pred_pose"])
                     .abs().max()) > 1e-2


def test_state_keys_are_the_published_layout(nets):
    """The port's keys are the twin's (the reference's module names) but
    the twin's constant buffers (the grid, the downsample matrix, the
    regressors' mean parameters), which the port, like the JAX package,
    builds from the asset files and keeps out of its state dict."""
    from torch_twins.pymaf_twin import PyMAFTwin
    _, _, pnet, _, (_, _, dmap) = nets
    twin = PyMAFTwin(None, dmap, np.zeros(144, np.float32),
                     np.zeros(10, np.float32), np.zeros(3, np.float32),
                     width=WIDTH, layers=LAYERS)
    consts = {"points_grid", "dmap"} | {
        f"regressor.{i}.init_{n}" for i in range(3)
        for n in ("pose", "shape", "cam")}
    twin_sd, port_sd = twin.state_dict(), pnet.state_dict()
    assert set(twin_sd) - set(port_sd) == consts
    assert set(port_sd) <= set(twin_sd)
    for k, v in port_sd.items():
        assert tuple(v.shape) == tuple(twin_sd[k].shape), k


def test_reference_checkpoint_loads_in_both(nets, tmp_path, capsys):
    """A reference-layout ``.pt`` (the twin's seeded state under ``model.``,
    with SMPL buffers and an IUV head the nets do not have) through each
    package's ``load_pymaf_checkpoint``: the same forward, 1e-4."""
    from icon_tpu.models.pymaf.convert import load_pymaf_checkpoint as jload
    from icon_tpu_torch.models.pymaf.convert import \
        load_pymaf_checkpoint as pload
    from torch_twins.pymaf_twin import PyMAFTwin
    jnet, variables, pnet, x, (_, _, dmap) = nets
    pnet = copy.deepcopy(pnet)            # the fixture's weights stay
    torch.manual_seed(7)
    twin = PyMAFTwin(None, dmap, np.zeros(144, np.float32),
                     np.zeros(10, np.float32), np.zeros(3, np.float32),
                     width=WIDTH, layers=LAYERS)
    rng = np.random.RandomState(8)
    state = {}
    for k, v in twin.state_dict().items():
        if k.endswith("running_var"):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(
                np.float32))
        elif k.endswith("running_mean"):
            v = torch.from_numpy(0.1 * rng.randn(*v.shape).astype(
                np.float32))
        state["model." + k] = v
    state["model.regressor.0.smpl.v_template"] = torch.zeros(100, 3)
    state["model.iuv_predictor.predict_u.weight"] = torch.zeros(25, 8, 1, 1)
    path = str(tmp_path / "pymaf.pt")
    torch.save(state, path)

    pload(pnet, path)
    assert "dropped" in capsys.readouterr().out
    for k, v in pnet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state["model." + k].numpy())
    jvars = jload(variables, path)
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        jvars, jnp.asarray(x))["smpl_out"][-1]
    with torch.no_grad():
        got = pnet(t(x))["smpl_out"][-1]
    for k in ("pred_pose", "pred_shape", "pred_cam", "verts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)

    del state["model.deconv_layers.0.weight"]
    torch.save(state, path)
    with pytest.raises(KeyError, match="lacks 1 PyMAF tensors"):
        pload(pnet, path)
