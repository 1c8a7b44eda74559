"""Port parity, the body model: icon_tpu_torch.models.smplx (lbs, BodyModel,
load_body_model, the synthetic models) against the JAX package with the
same numpy inputs.

Vertices and joints to 1e-5 (float32 sums in another order); gradients of
a seeded weighted sum of the vertices to 1e-4 of their largest magnitude;
loaded and synthetic arrays identical."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu.models.smplx import body as jbody
from icon_tpu.models.smplx.lbs import batch_rodrigues as jrodrigues
from icon_tpu_torch.models.smplx import body as pbody
from icon_tpu_torch.models.smplx.lbs import batch_rodrigues
from icon_tpu_torch.utils.convert import body_model_from_jax

ATOL = 1e-5
GRAD_RTOL = 1e-4


def _models():
    return {"smpl": jbody.synthetic_body_model(n_verts=96, n_joints=6),
            "smplx": jbody.synthetic_smplx_model(subdiv=2)}


MODELS = _models()


def test_batch_rodrigues_parity():
    aa = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    aa[0] = 0.0                                   # the eps guard
    np.testing.assert_allclose(batch_rodrigues(t(aa)).numpy(),
                               np.asarray(jrodrigues(
                                   jnp.asarray(aa))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_synthetic_models_are_the_same_arrays(name):
    jm = MODELS[name]
    pm = pbody.synthetic_body_model(n_verts=96, n_joints=6) \
        if name == "smpl" else pbody.synthetic_smplx_model(subdiv=2)
    for key in pbody._ARRAYS:
        want = getattr(jm, key)
        got = getattr(pm, key)
        assert (got is None) == (want is None), key
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pm.faces, jm.faces)
    assert pm.parents == jm.parents
    assert (pm.model_type, pm.num_betas) == (jm.model_type, jm.num_betas)


def _inputs(name, case, rng):
    """Keyword arguments of ``forward`` for one case, as numpy."""
    model = MODELS[name]
    nb = model.num_joints - 1
    n_body = nb if name == "smpl" else jbody.SMPLX_NUM_BODY_JOINTS
    kw = {"betas": rng.randn(2, 10).astype(np.float32) * 0.8}
    if case == "rotmat":
        aa = rng.randn(2 * (nb + 1), 3).astype(np.float32) * 0.4
        rot = np.asarray(jrodrigues(jnp.asarray(aa))).reshape(
            2, nb + 1, 9)
        kw["global_orient"] = rot[:, 0]
        kw["body_pose"] = rot[:, 1:n_body + 1].reshape(2, -1)
        kw["pose2rot"] = False
    else:
        kw["global_orient"] = rng.randn(2, 3).astype(np.float32) * 0.4
        kw["body_pose"] = rng.randn(2, n_body * 3).astype(np.float32) * 0.4
    if case == "scale_transl":
        kw["scale"] = rng.uniform(0.5, 1.5, (2, 1)).astype(np.float32)
        kw["transl"] = rng.randn(2, 3).astype(np.float32)
    if case == "scalar_scale":
        kw["scale"] = np.float32(1.3)
    if name == "smplx" and case == "hands_face":
        kw["expression"] = rng.randn(2, 10).astype(np.float32)
        kw["jaw_pose"] = rng.randn(2, 3).astype(np.float32) * 0.2
        kw["leye_pose"] = rng.randn(2, 3).astype(np.float32) * 0.2
        kw["left_hand_pose"] = rng.randn(2, 6).astype(np.float32)   # PCA
        kw["right_hand_pose"] = rng.randn(2, 45).astype(np.float32) * 0.2
    if case == "extra_pose":
        extra = (model.num_joints - 1 - n_body) * 3
        kw["extra_pose"] = rng.randn(2, extra).astype(np.float32) * 0.3
    return kw


CASES = ["axis_angle", "rotmat", "scale_transl", "scalar_scale"]
SMPLX_CASES = ["hands_face", "extra_pose"]      # SMPL has no such joints


@pytest.mark.parametrize("name,case", [(n, c) for n in sorted(MODELS)
                                       for c in CASES] +
                         [("smplx", c) for c in SMPLX_CASES])
def test_forward_parity(name, case):
    kw = _inputs(name, case, np.random.RandomState(len(case)))
    jm = MODELS[name]
    pm = body_model_from_jax(jm)
    jv, jj = jm.forward(**{k: v if isinstance(v, bool) else jnp.asarray(v)
                           for k, v in kw.items()})
    pv, pj = pm(**{k: v if isinstance(v, bool) else t(v)
                   for k, v in kw.items()})
    assert pv.shape == jv.shape and pj.shape == jj.shape
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pj.numpy(), np.asarray(jj), rtol=0, atol=ATOL)
    assert float(np.abs(np.asarray(jv) - np.asarray(jm.v_template)).max()) \
        > 1e-3                                  # the pose did something


def test_default_pose_and_identity_pad():
    """No pose at all; and ``pose2rot=False`` with only the root given,
    which pads every other joint with identity rotations."""
    for jm in MODELS.values():
        pm = body_model_from_jax(jm)
        np.testing.assert_allclose(pm()[0].numpy(), np.asarray(jm.forward()[0]),
                                   rtol=0, atol=ATOL)
        eye = np.eye(3, dtype=np.float32).reshape(1, 9)
        jv, _ = jm.forward(global_orient=jnp.asarray(eye), pose2rot=False)
        pv, _ = pm(global_orient=t(eye), pose2rot=False)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("pose2rot", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_grad_parity(name, pose2rot):
    """Gradients of sum(w * verts) w.r.t. betas, body pose and orientation
    (axis-angle, or raw rotation matrices as the fit optimizes them)."""
    case = "axis_angle" if pose2rot else "rotmat"
    kw = _inputs(name, case, np.random.RandomState(11))
    kw = {k: kw[k] for k in ("betas", "global_orient", "body_pose")}
    jm = MODELS[name]
    pm = body_model_from_jax(jm)
    w = np.random.RandomState(12).randn(2, jm.v_template.shape[0], 3).astype(
        np.float32)

    def jloss(params):
        v, _ = jm.forward(pose2rot=pose2rot, **params)
        return jnp.sum(v * w)

    jgrads = jax.grad(jloss)({k: jnp.asarray(v) for k, v in kw.items()})
    params = {k: t(v).requires_grad_(True) for k, v in kw.items()}
    v, _ = pm(pose2rot=pose2rot, **params)
    torch.sum(v * t(w)).backward()
    for k in kw:
        want = np.asarray(jgrads[k])
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * scale)


def _release_npz(path, model, n_shape=300, n_expr=10):
    """``model`` written in the SMPL-X release layout: shapedirs with 300
    shape columns then the expression columns, posedirs ``[V, 3, P]``, the
    kintree table, hand PCA under the release names."""
    rng = np.random.RandomState(3)
    V = model.v_template.shape[0]
    sd = np.zeros((V, 3, n_shape + n_expr), np.float32)
    sd[:, :, :10] = np.asarray(model.shapedirs)
    sd[:, :, 10:n_shape] = rng.randn(V, 3, n_shape - 10) * 0.01
    sd[:, :, n_shape:] = np.asarray(model.expr_dirs)
    posedirs = np.asarray(model.posedirs).T.reshape(V, 3, -1)
    parents = np.array(model.parents, np.int64)
    parents[0] = -1
    kintree = np.stack([parents, np.arange(len(parents))])
    np.savez(path, v_template=np.asarray(model.v_template), shapedirs=sd,
             posedirs=posedirs, J_regressor=np.asarray(model.J_regressor),
             weights=np.asarray(model.lbs_weights), f=model.faces,
             kintree_table=kintree,
             hands_componentsl=np.asarray(model.hands_components_l),
             hands_componentsr=np.asarray(model.hands_components_r),
             hands_meanl=np.asarray(model.hands_mean_l),
             hands_meanr=np.asarray(model.hands_mean_r))


@pytest.mark.parametrize("num_betas", [10, 4])
def test_load_body_model_parity(tmp_path, num_betas):
    path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    _release_npz(path, MODELS["smplx"])
    jm = jbody.load_body_model(path, num_betas=num_betas,
                               num_expression_coeffs=6)
    pm = pbody.load_body_model(path, num_betas=num_betas,
                               num_expression_coeffs=6)
    assert pm.model_type == jm.model_type == "smplx"
    assert pm.num_betas == jm.num_betas == num_betas
    assert pm.parents == jm.parents
    np.testing.assert_array_equal(pm.faces, jm.faces)
    for key in pbody._ARRAYS:
        np.testing.assert_array_equal(getattr(pm, key).numpy(),
                                      np.asarray(getattr(jm, key)))
    # the loaded model poses like the synthetic one it was written from
    kw = _inputs("smplx", "hands_face", np.random.RandomState(2))
    kw["betas"] = kw["betas"][:, :num_betas]
    kw["expression"] = kw["expression"][:, :6]
    pv, _ = pm(**{k: t(v) for k, v in kw.items()})
    jv, _ = jm.forward(**{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)


def test_body_model_moves_with_to():
    pm = body_model_from_jax(MODELS["smplx"]).to(torch.float64)
    assert pm.posedirs.dtype == torch.float64
    assert {n for n, _ in pm.named_buffers()} == set(pbody._ARRAYS)
