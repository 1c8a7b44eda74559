"""Port parity, PIXIE (``icon_tpu_torch.models.pixie``: the HRNet body
encoder with its 'concat' head, the ResNet part experts, the extractors,
moderators and regressors, the pose math, the part crops and the SMPL-X
decode) against the JAX package's ``icon_tpu.models.pixie`` on the CPU.

Narrow widths (HRNet width 8, ResNet width 8 with one block a stage, MLPs
of 32, 64^2 inputs); the JAX variables are drawn from a seed on the
``jax.eval_shape`` tree, the regressors' and moderators' last layers
scaled around the rest body (``torch_port_helpers.pixie_pair``), and reach
the port through ``utils/convert.py:pixie_state_from_flax``. Compared, each
to 1e-5 of the array's largest magnitude: the body feature and the part shares, the
coarse and fused parameters with the moderators' weights, the decoded
SMPL-X vertices (the hand vertices on their own too), joints and
rotation matrices, the whole estimator, and every pose function alone.
The two thresholds (the hand expert's snap at 0.7, the head clamp) are
asserted to take the same branch in both packages, away from the edge.

The published widths' layout is held leaf for leaf (``jax.eval_shape``).
The loaders: the port's seeded state written in the published layout loads
into a NaN-filled JAX tree with the JAX loader, every leaf written; the
port's loader raises on a missing, an unexpected and a misshapen tensor.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (PIXIE_NARROW as NARROW, nan_variables,
                                pixie_pair, rel_err, t, unwritten_leaves)

import icon_tpu.models.pixie.net as J
import icon_tpu_torch.models.pixie.net as P

RTOL = 1e-5               # of each array's largest magnitude
IMG = 64
MARGIN = 1e-3             # a threshold's input must stand this far off


def _shapes(kw, img=IMG):
    from torch_port_helpers import pixie_shapes
    return pixie_shapes(kw, img)


@pytest.fixture(scope="module")
def pair():
    """(JAX estimator, its variables, the port's estimator with them)."""
    return pixie_pair()


def _images(seed, n=4, b=2):
    rng = np.random.RandomState(seed)
    return [rng.rand(b, IMG, IMG, 3).astype(np.float32) for _ in range(n)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, name):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _close(got[k], want[k], f"{name}/{k}")
        return
    err = rel_err(got, want)
    assert err <= RTOL, (name, err)


def test_stages_match_jax(pair):
    """The body feature and the part shares, the coarse parameters, the
    fused parameters and the moderators' weights; the hand snap takes the
    same branch in both, every weight MARGIN off 0.7."""
    jest, v, pest = pair
    body, head, lh, rh = _images(0)
    apply = jax.jit(lambda v, *a, method: jest.net.apply(v, *a,
                                                         method=method),
                    static_argnames="method")
    f_body, shares = apply(v, body, method=J.PIXIE.encode_body)
    coarse = apply(v, f_body, shares, method=J.PIXIE.coarse_params)
    fused, weights = apply(v, f_body, shares, head, lh, rh,
                           method=J.PIXIE.fused_params)
    with torch.no_grad():
        pf, ps = pest.net.encode_body(_nchw(body))
        pc = pest.net.coarse_params(pf, ps)
        pfu, pw = pest.net.fused_params(pf, ps, _nchw(head), _nchw(lh),
                                        _nchw(rh))
    _close(pf, f_body, "f_body")
    _close(ps, shares, "shares")
    _close(pc, coarse, "coarse")
    _close(pfu, fused, "fused")
    _close(pw, weights, "weights")
    snapped = []
    for part in ("left_hand", "right_hand"):
        w = np.asarray(weights[part])[:, 1]
        assert np.abs(w - 0.7).min() > MARGIN, w
        np.testing.assert_array_equal(pw[part][:, 1].numpy() > 0.7, w > 0.7)
        snapped += list(w > 0.7)
    assert any(snapped) and not all(snapped), snapped


def _params(seed, cfg, scale=1.0):
    """Seeded raw parameters in PIXIE's layouts, the 6D poses near the
    identity plus ``scale`` times noise."""
    rng = np.random.RandomState(seed)
    out = {}
    for layout in (cfg.body_layout, cfg.head_share_layout,
                   cfg.hand_share_layout):
        for k, d in layout.items():
            out[k] = (0.3 * rng.randn(2, d)).astype(np.float32)
    out["left_wrist_pose"] = out["right_wrist_pose"] + 0.1
    out["left_hand_pose"] = out["right_hand_pose"][:, ::-1].copy()
    eye = np.array([1, 0, 0, 1, 0, 0], np.float32)
    for k, v in out.items():
        if k.endswith("_pose") and k != "jaw_pose":
            out[k] = (np.tile(eye, v.shape[1] // 6)[None]
                      + scale * v).astype(np.float32)
    out["body_cam"][:, 0] += 0.9
    return out


def _head_euler(body_pose_fn, params, to):
    """The head's Euler angles before the clamp, from the composition
    without ``check_pose``."""
    rots = body_pose_fn({k: to(v) for k, v in params.items()},
                        check_pose=False)
    return rots["body_pose"][:, 14]


@pytest.mark.parametrize("scale", [0.05, 0.6], ids=["near_rest", "clamped"])
def test_decode_matches_jax(pair, scale):
    """The SMPL-X decode (pose composition, axis-angle, expression cut, hand
    mean cancelled): vertices, the hand vertices alone, joints and rotation
    matrices; the head clamp zeroes the same components in both, each
    Euler angle MARGIN off its limit (the 0.6 case clamps some)."""
    jest, _, pest = pair
    params = _params(1, pest.cfg, scale)
    want = jax.jit(jest.decode_params)({k: jnp.asarray(v)
                                        for k, v in params.items()})
    with torch.no_grad():
        got = pest.decode_params({k: t(v) for k, v in params.items()})
    for k in ("vertices", "joints", "global_pose", "body_pose", "jaw_pose",
              "left_hand_pose", "right_hand_pose", "cam"):
        _close(got[k], want[k], k)
    hand = np.isin(pest.body.lbs_weights.numpy().argmax(1),
                   np.arange(25, 55))
    assert hand.sum() > 100
    _close(got["vertices"][:, hand], np.asarray(want["vertices"])[:, hand],
           "hand vertices")
    je = np.asarray(J.rotmat_to_euler_xyz(_head_euler(
        J.compose_body_pose, params, jnp.asarray)))
    pe = P.rotmat_to_euler_xyz(_head_euler(P.compose_body_pose, params,
                                           t)).numpy()
    lim = np.radians(P.HEAD_LIMITS_DEG)
    assert np.abs(np.abs(je) - lim).min() > MARGIN
    np.testing.assert_array_equal(np.abs(pe) > lim, np.abs(je) > lim)
    assert (np.abs(je) > lim).any() == (scale > 0.5)


def test_estimator_matches_jax(pair):
    """The whole estimator on a 64^2 image: coarse pass, part boxes from
    its projected joints, 224^2 crops, fused pass, decode."""
    jest, _, pest = pair
    (img,) = _images(2, n=1)
    want = jest(jnp.asarray(img))
    with torch.no_grad():
        got = pest(torch.from_numpy(img))
    for k in ("vertices", "joints", "global_pose", "body_pose", "jaw_pose",
              "left_hand_pose", "right_hand_pose", "shape", "exp", "cam",
              "crop_boxes"):
        _close(got[k], want[k], k)


def test_hand_mean_is_cancelled(pair):
    """PIXIE's hand rotations reach the body as they are: identity hand
    rotations give the hands of a body with a flat hand mean and zero hand
    pose (the body model adds the mean to axis-angle hands)."""
    import copy
    _, _, pest = pair
    params = _params(4, pest.cfg, 0.0)
    body = pest.body
    assert float(body.hands_mean_l.abs().max()) > 0.01
    with torch.no_grad():
        rots = pest.decode_params({k: t(v) for k, v in params.items()})
        flat = copy.deepcopy(body)
        flat.flat_hand_mean = True
        aa = P.rotmat_to_angle_axis
        want, _ = flat(
            betas=t(params["shape"])[:, :body.num_betas],
            global_orient=aa(rots["global_pose"].reshape(-1, 3, 3)
                             ).reshape(2, -1),
            body_pose=aa(rots["body_pose"].reshape(-1, 3, 3)).reshape(2, -1),
            jaw_pose=aa(rots["jaw_pose"].reshape(-1, 3, 3)).reshape(2, -1),
            expression=t(params["exp"])[:, :body.expr_dirs.shape[-1]],
            left_hand_pose=torch.zeros(2, 45),
            right_hand_pose=torch.zeros(2, 45))
    np.testing.assert_allclose(rots["vertices"].numpy(), want.numpy(),
                               atol=1e-6)


def _rotations(rng, n):
    from icon_tpu_torch.models.smplx.lbs import batch_rodrigues
    return batch_rodrigues(t(0.8 * rng.randn(n, 3))).numpy()


def _pose_case(name, rng):
    """(args as numpy, kwargs) of the pose function ``name``."""
    if name == "euler_to_rotmat":
        return (0.7 * rng.randn(16, 3),), {}
    if name in ("rotmat_to_euler_xyz", "flip_rotmat"):
        return (_rotations(rng, 16),), {}
    if name == "cont_to_rotmat":
        return (rng.randn(3, 4 * 6),), {}
    if name == "pose_abs2rel":
        return (_rotations(rng, 2)[:, None], _rotations(rng, 42).reshape(
            2, 21, 3, 3)), {"abs_joint": "left_wrist"}
    if name == "clamp_head_pose":
        pose = _rotations(rng, 42).reshape(2, 21, 3, 3)
        pose[1, 14] = J.euler_to_rotmat(jnp.array([[0.1, 0.5, 0.05]]))[0]
        return (pose,), {}
    if name == "compose_body_pose":
        return (_params(7, P.PixieConfig(**NARROW), 0.4),), {}
    if name == "batch_orth_proj":
        return (rng.randn(2, 55, 3), rng.randn(2, 3)), {}
    if name == "crop_part_boxes":
        return (0.5 * rng.randn(2, 55, 2),), {}
    if name == "crop_resize":
        return (rng.rand(2, 20, 28, 3),
                np.array([[0.1, -0.2, 0.3], [-0.5, 0.4, 0.8]])), \
            {"out_size": 17}
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "euler_to_rotmat", "rotmat_to_euler_xyz", "cont_to_rotmat",
    "pose_abs2rel", "flip_rotmat", "clamp_head_pose", "compose_body_pose",
    "batch_orth_proj", "crop_part_boxes", "crop_resize"])
def test_pose_function_matches_jax(name):
    """Each pose and crop function on seeded inputs; ``crop_resize`` takes
    NCHW in the port (x along W) and NHWC in the JAX package."""
    args, kw = _pose_case(name, np.random.RandomState(len(name)))

    def conv(a, to):
        if isinstance(a, dict):
            return {k: to(np.asarray(v, np.float32)) for k, v in a.items()}
        return to(np.asarray(a, np.float32))
    jargs = [conv(a, jnp.asarray) for a in args]
    pargs = [conv(a, t) for a in args]
    if name == "crop_resize":
        pargs[0] = pargs[0].permute(0, 3, 1, 2)
    want = getattr(J, name)(*jargs, **kw)
    with torch.no_grad():
        got = getattr(P, name)(*pargs, **kw)
    if name == "crop_resize":
        got = got.permute(0, 2, 3, 1)
    _close(got, want, name)


def test_published_layout_matches():
    """At the published widths the JAX PIXIE's variables, through
    ``pixie_state_from_flax``, give the port's state dict name for name and
    shape for shape (the JAX tree by ``jax.eval_shape``, the port's on the
    meta device)."""
    from icon_tpu_torch.utils.convert import pixie_state_from_flax
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   _shapes({}, img=224))
    want = pixie_state_from_flax(zeros)
    with torch.device("meta"):
        got = P.PIXIE().state_dict()
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in got)
    n = sum(v.numel() for k, v in got.items()
            if not k.endswith("num_batches_tracked"))
    assert 190e6 < n < 200e6
    assert {k.split(".")[0] for k in got} == {
        "Encoder_body", "Encoder_head", "Encoder_hand", "Regressor_body",
        "Regressor_head", "Regressor_head_share", "Regressor_hand",
        "Regressor_hand_share", "Extractor_head_share",
        "Extractor_left_hand_share", "Extractor_right_hand_share",
        "Moderator_head_share", "Moderator_hand_share"}


@pytest.fixture(scope="module")
def seeded_file(tmp_path_factory):
    """The port's seeded narrow state in the published file layout."""
    from icon_tpu_torch.utils.synthetic import (pixie_file_layout,
                                                seeded_pixie_state)
    state = seeded_pixie_state(5, P.PixieConfig(**NARROW))
    path = str(tmp_path_factory.mktemp("pixie") / "pixie_model.tar")
    torch.save(pixie_file_layout(state), path)
    return path, state


def test_jax_loader_writes_every_leaf(seeded_file, capsys):
    """The JAX package's ``load_pixie_checkpoint`` on the port's file fills
    a NaN tree completely; the port's loader reads the same file strictly
    (dropping the six MEAN/STD buffers) into the same weights."""
    from icon_tpu.models.pixie.convert import load_pixie_checkpoint as jload
    from icon_tpu_torch.models.pixie.convert import load_pixie_checkpoint
    from icon_tpu_torch.utils.convert import pixie_state_from_flax
    path, state = seeded_file
    variables = jload(nan_variables(_shapes(NARROW)), path)
    assert unwritten_leaves(variables) == []
    back = pixie_state_from_flax(variables)
    net = load_pixie_checkpoint(P.PIXIE(P.PixieConfig(**NARROW)), path)
    assert "dropped the encoders' 6 MEAN/STD" in capsys.readouterr().out
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), k)
        np.testing.assert_array_equal(back[k], state[k].numpy(), k)


def test_loader_is_strict(seeded_file, tmp_path):
    from icon_tpu_torch.models.pixie.convert import load_pixie_checkpoint
    path, _ = seeded_file
    ckpt = torch.load(path, weights_only=False)

    def load(c):
        p = str(tmp_path / "x.tar")
        torch.save(c, p)
        return load_pixie_checkpoint(P.PIXIE(P.PixieConfig(**NARROW)), p)

    bad = {k: dict(v) for k, v in ckpt.items()}
    del bad["Regressor_hand"]["layers.2.bias"]
    with pytest.raises(KeyError, match="lacks 1 PIXIE tensors"):
        load(bad)
    bad = {k: dict(v) for k, v in ckpt.items()}
    bad["Encoder_hand"]["encoder.fc.weight"] = torch.zeros(2, 2)
    with pytest.raises(KeyError, match="no place"):
        load(bad)
    bad = {k: dict(v) for k, v in ckpt.items()}
    bad["Moderator_hand_share"]["temperature"] = torch.ones(2)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load(bad)
