"""Port parity, the demo's optimization loops: icon_tpu_torch.ops.mesh_losses,
models.local_affine and infer.refine against the JAX package with the same
numpy inputs.

Mesh losses and the local affine to 1e-6; the optimizers against optax
(the plateau scale, best value and count identical over a scripted loss
sequence; parameters to 1e-6 after a few steps); the loops at 64^2 on the
subdiv-3 synthetic SMPL-X body with a narrow NormalNet: each iteration's
loss to 1e-4 relative and the final parameters to 1e-4 (float32 sums in
another order; the rasterizer's pixels are identical)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from torch_port_helpers import (init_jax_icon, normalnet_cfg, port_cfg,
                                port_state, t)

from icon_tpu.utils.synthetic import icosphere, synthetic_body
from icon_tpu_torch.infer import refine as prefine
from icon_tpu_torch.models import local_affine as pla
from icon_tpu_torch.ops import mesh_losses as pml

RNG = np.random.RandomState(5)
ATOL = 1e-6
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
SIZE = 64


def _mesh():
    v, f = icosphere(subdiv=2)
    return (v * (1 + 0.2 * RNG.rand(len(v), 1))).astype(np.float32), f


def test_mesh_edges_and_adjacency_identical():
    from icon_tpu.ops import mesh_losses as jml
    _, f = synthetic_body(subdiv=3)
    np.testing.assert_array_equal(pml.mesh_edges(f), jml.mesh_edges(f))
    np.testing.assert_array_equal(pml.edge_face_adjacency(f),
                                  jml.edge_face_adjacency(f))


@pytest.mark.parametrize("loss", ["laplacian_loss", "edge_length_loss",
                                  "normal_consistency_loss"])
def test_mesh_loss_parity(loss):
    from icon_tpu.ops import mesh_losses as jml
    v, f = _mesh()
    edges = jml.mesh_edges(f)
    pairs = jml.edge_face_adjacency(f)
    if loss == "normal_consistency_loss":
        jargs, pargs = (f, pairs), (t(f, torch.int64), t(pairs, torch.int64))
    else:
        jargs, pargs = (edges,), (t(edges, torch.int64),)
    want = getattr(jml, loss)(jnp.asarray(v), *map(jnp.asarray, jargs))
    pv = t(v).requires_grad_(True)
    got = getattr(pml, loss)(pv, *pargs)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0,
                               atol=ATOL)
    assert float(got.detach()) > 0
    # and its gradient, which the cloth loop follows
    jg = jax.grad(lambda x: getattr(jml, loss)(x, *map(jnp.asarray, jargs)))(
        jnp.asarray(v))
    got.backward()
    np.testing.assert_allclose(pv.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=ATOL)


def test_local_affine_parity():
    from icon_tpu.models import local_affine as jla
    v, f = _mesh()
    edges = pml.mesh_edges(f)
    n = len(v)
    params = {"A": (np.eye(3)[None] + 0.1 * RNG.randn(n, 3, 3)).astype(
        np.float32), "t": (0.05 * RNG.randn(n, 3)).astype(np.float32)}
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    pp = {k: t(x) for k, x in params.items()}
    for name, jv, pv in (
            ("apply", jla.apply_local_affine(jp, jnp.asarray(v)),
             pla.apply_local_affine(pp, t(v))),
            ("stiffness", jla.stiffness_loss(jp, jnp.asarray(edges)),
             pla.stiffness_loss(pp, t(edges, torch.int64))),
            ("rigid", jla.rigid_loss(jp), pla.rigid_loss(pp))):
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                                   atol=ATOL, err_msg=name)
    init = pla.init_local_affine(n, device="cpu")
    jinit = jla.init_local_affine(n)
    for k in ("A", "t"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))
    assert float(pla.rigid_loss(init)) == 0.0


# -- optimizers --------------------------------------------------------------

# a scripted loss sequence: improvements, plateaus longer and shorter than
# the patience, values within rtol of the best, a rise
LOSSES = [1.0, 0.9, 0.95, 0.9, 0.89995, 0.8999, 0.91, 0.89992, 0.92, 0.92,
          0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.49,
          0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6,
          0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]


@pytest.mark.parametrize("patience", [1, 3, 5])
def test_plateau_matches_optax(patience):
    tx = optax.contrib.reduce_on_plateau(factor=0.5, patience=patience,
                                         min_scale=1e-2)
    params = {"x": jnp.zeros(2)}
    jstate = tx.init(params)
    state = prefine.sgd_plateau_init({"x": torch.zeros(2)})
    scales = []
    for value in LOSSES:
        _, jstate = tx.update(params, jstate, params,
                              value=jnp.float32(value))
        state = prefine.plateau_update(state, torch.tensor(value), 0.5,
                                       patience, 1e-2)
        assert float(state.scale) == float(jstate.scale)
        assert float(state.best) == float(jstate.best_value)
        assert int(state.plateau) == int(jstate.plateau_count)
        scales.append(float(state.scale))
    assert min(scales) == np.float32(1e-2) or patience == 5
    assert len(set(scales)) > 2


def _toy_grads(step, params):
    return {k: np.sin(3.0 * v + step).astype(np.float32)
            for k, v in params.items()}


def test_sgd_plateau_step_matches_optax():
    tx = optax.chain(optax.sgd(1e-2, momentum=0.9),
                     optax.contrib.reduce_on_plateau(factor=0.5, patience=2,
                                                     min_scale=1e-2))
    start = {"a": RNG.randn(4, 3, 3).astype(np.float32),
             "b": RNG.randn(3).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = tx.init(jp)
    pp = {k: t(v) for k, v in start.items()}
    state = prefine.sgd_plateau_init(pp)
    for step, value in enumerate(LOSSES[:12]):
        g = _toy_grads(step, {k: np.asarray(v) for k, v in jp.items()})
        upd, jstate = tx.update({k: jnp.asarray(x) for k, x in g.items()},
                                jstate, jp, value=jnp.float32(value))
        jp = optax.apply_updates(jp, upd)
        state = prefine.sgd_plateau_step(pp, {k: t(x) for k, x in g.items()},
                                         state, torch.tensor(value), 1e-2,
                                         patience=2)
        for k in start:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=ATOL)
    assert float(state.scale) < 1.0


def test_adam_step_matches_optax():
    tx = optax.adam(1e-2)
    start = {"a": RNG.randn(5, 3).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = tx.init(jp)
    pp = {k: t(v) for k, v in start.items()}
    state = prefine.adam_init(pp)
    for step in range(8):
        g = _toy_grads(step, {k: np.asarray(v) for k, v in jp.items()})
        upd, jstate = tx.update({k: jnp.asarray(x) for k, x in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = prefine.adam_step(pp, {k: t(x) for k, x in g.items()}, state,
                                  1e-2)
        np.testing.assert_allclose(pp["a"].numpy(), np.asarray(jp["a"]),
                                   rtol=0, atol=ATOL)


# -- the loops ---------------------------------------------------------------

@pytest.fixture(scope="module")
def fit_setup():
    """The subdiv-3 synthetic SMPL-X in both packages, the demo's item at
    64^2 and a narrow NormalNet with the same weights."""
    from icon_tpu.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.utils.convert import body_model_from_jax
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    jbody = synthetic_smplx_model(subdiv=3)
    pbody = body_model_from_jax(jbody)
    item = synthetic_fit_item(pbody, SIZE, seed=1)
    cfg = normalnet_cfg()
    jnet, variables = init_jax_icon(cfg, seed=2, normal_net=True)
    pnet = HGPIFuNet(port_cfg(cfg))
    pnet.load_state_dict(port_state(variables))
    pnet.eval()
    return jbody, pbody, item, (jnet, variables), pnet


def test_refine_smpl_live_parity(fit_setup):
    from icon_tpu.infer.refine import refine_smpl_live as jrefine
    jbody, pbody, item, (jnet, variables), pnet = fit_setup
    assert 0.005 < item["mask"].mean() < 0.5

    def jnormal_fn(in_t):
        return jnet.apply(variables, in_t, False,
                          method=jnet.predict_normals)

    iters = 4
    jverts, (jnF, jnB), jlosses, jparams, jframes = jrefine(
        jbody, jbody.faces, jnp.asarray(item["image"]), item["init"],
        jnormal_fn, item["scale"], iters=iters, size=SIZE,
        mask=jnp.asarray(item["mask"]), capture_every=2)
    faces = t(pbody.faces, torch.int64)
    fit = prefine.refine_smpl_live(
        pbody, faces, t(item["image"]), item["init"], pnet.predict_normals,
        item["scale"], t(item["mask"]), iters=iters, size=SIZE,
        capture_every=2)
    assert len(fit.losses) == iters and np.isfinite(fit.losses).all()
    np.testing.assert_allclose(fit.losses, jlosses, rtol=LOSS_RTOL, atol=0)
    assert fit.losses[-1] != fit.losses[0]
    for k, v in fit.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
        assert float(np.abs(v.numpy() - item["init"][k]).max()) > 0, k
    np.testing.assert_allclose(fit.verts.numpy(), jverts, rtol=0,
                               atol=PARAM_ATOL)
    # the last predictions, from renders of bodies 1e-7 apart through the
    # NormalNet's two generators (a few pixels of 12,288 move by ~2e-4)
    for got, want in zip(fit.normals, (jnF, jnB)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-3)
    # the gif's panel rows [input | body normals | cloth normals] at
    # iterations 0, 2 and the last: uint8 within 1 (the normals' 1e-3
    # above can cross a rounding step)
    assert len(fit.frames) == len(jframes) == 3
    for got, want in zip(fit.frames, jframes):
        assert got.dtype == np.uint8 and got.shape == want.shape == \
            (SIZE, 3 * SIZE, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_hps_body_normals_parity(fit_setup):
    """The ``-loop_smpl 0`` branch against the JAX CLI's
    (``icon_tpu/apps/infer.py:179-194``) on the same body, item and
    NormalNet: the HPS body's vertices to 1e-4 and the cloth normals
    predicted from its renders at azimuth 0 and 180 to 1e-3 (as in the
    fit's parity above: a few pixels move by ~2e-4 through the two
    generators)."""
    from icon_tpu.render.render import render_normal
    jbody, pbody, item, (jnet, variables), pnet = fit_setup
    init = item["init"]
    nb = init["body_pose"].shape[1]
    v0, _ = jbody.forward(
        betas=jnp.asarray(init["betas"]),
        global_orient=jnp.asarray(init["global_orient"]).reshape(1, 9),
        body_pose=jnp.asarray(init["body_pose"]).reshape(1, nb * 9),
        pose2rot=False)
    jverts = (v0[0] + jnp.asarray(init["trans"])[None]) * item["scale"]
    jfaces = jnp.asarray(jbody.faces)
    t_f, _ = render_normal(jverts, jfaces, size=SIZE)
    t_b, _ = render_normal(jverts, jfaces, size=SIZE, azimuth=180.0)
    image = jnp.asarray(item["image"])
    want = jnet.apply(variables, {"image": image[None], "T_normal_F":
                                  t_f[None], "T_normal_B": t_b[None]},
                      False, method=jnet.predict_normals)
    fit = prefine.hps_body_normals(
        pbody, t(pbody.faces, torch.int64), t(item["image"]), init,
        pnet.predict_normals, item["scale"], size=SIZE)
    assert fit.losses == [] and fit.frames == ()
    np.testing.assert_allclose(fit.verts.numpy(), np.asarray(jverts),
                               rtol=0, atol=PARAM_ATOL)
    for got, w in zip(fit.normals, want):
        assert got.shape == (SIZE, SIZE, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(w[0]), rtol=0,
                                   atol=1e-3)


def test_refine_cloth_parity():
    """The demo's weights and learning rate on a jittered body (an exactly
    symmetric mesh has gradients that cancel to rounding noise, and Adam's
    first step moves such a parameter by +-lr on the noise's sign) against
    the normals of a bumpier copy."""
    from icon_tpu.infer.refine import refine_cloth as jrefine
    from icon_tpu.render.render import render_normal
    v, f = synthetic_body(subdiv=3)
    rng = np.random.RandomState(9)
    v = v * (1 + 0.01 * rng.randn(len(v), 3)).astype(np.float32)
    bumpy = v * (1 + 0.05 * rng.randn(len(v), 1)).astype(np.float32)
    gF, _ = render_normal(jnp.asarray(bumpy), jnp.asarray(f), size=SIZE)
    gB, _ = render_normal(jnp.asarray(bumpy), jnp.asarray(f), size=SIZE,
                          azimuth=180.0)
    iters = 3
    jv, jlosses = jrefine(v, f, gF, gB, iters=iters, size=SIZE, w_edge=1.0)
    pv, losses = prefine.refine_cloth(t(v), t(f, torch.int64),
                                      t(np.asarray(gF)), t(np.asarray(gB)),
                                      iters=iters, size=SIZE, w_edge=1.0)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    assert len(set(losses)) == iters
    np.testing.assert_allclose(pv.numpy(), jv, rtol=0, atol=PARAM_ATOL)
    assert float(np.abs(pv.numpy() - v).max()) > 1e-4


def _sphere_body():
    """tests/test_refine.py's one-joint sphere body, in both packages."""
    from icon_tpu.models.smplx.body import BodyModel
    from icon_tpu_torch.utils.convert import body_model_from_jax
    v, f = icosphere(subdiv=2, radius=0.5)
    rng = np.random.RandomState(5)
    jm = BodyModel(
        v_template=jnp.asarray(v),
        shapedirs=jnp.asarray(rng.randn(len(v), 3, 4).astype(np.float32)
                              * 0.05),
        posedirs=jnp.zeros((0, len(v) * 3)),
        J_regressor=jnp.ones((1, len(v))) / len(v),
        lbs_weights=jnp.ones((len(v), 1)),
        faces=f, parents=(0,), model_type="smpl", num_betas=4)
    return jm, body_model_from_jax(jm), f


def test_refine_smpl_reduces_loss():
    """tests/test_refine.py:63 on the port: Adam on the betas of a sphere
    body toward a target render lowers the loss, NaN-free. The first loss
    equals the JAX loop's; the later ones are not compared: the depth
    translation's true gradient is zero, its rounding noise differs between
    the packages, and Adam's normalized step turns that noise into a full
    step."""
    from icon_tpu.infer.refine import refine_smpl as jrefine
    from icon_tpu.render.render import render_normal, render_silhouette
    jm, pm, f = _sphere_body()
    tv, _ = jm.forward(betas=jnp.asarray([[0.8, -0.5, 0.3, 0.2]]))
    gF, _ = render_normal(tv[0], jnp.asarray(f), size=SIZE)
    gB, _ = render_normal(tv[0], jnp.asarray(f), size=SIZE, azimuth=180.0)
    gS = render_silhouette(tv[0], jnp.asarray(f), size=SIZE)
    init = {"betas": np.zeros((1, 4), np.float32),
            "body_pose": np.zeros((1, 0), np.float32),
            "global_orient": np.zeros((1, 3), np.float32),
            "trans": np.zeros((1, 3), np.float32)}
    params, verts, losses = prefine.refine_smpl(
        pm, t(f, torch.int64), init, *(t(np.asarray(x)) for x in
                                       (gF, gB, gS)),
        iters=30, lr=5e-2, size=SIZE)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert torch.isfinite(verts).all()
    _, _, jlosses = jrefine(jm, f, init, gF, gB, gS, iters=30, lr=5e-2,
                            size=SIZE)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=LOSS_RTOL,
                               atol=0)
