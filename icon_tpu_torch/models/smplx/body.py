"""SMPL-family body model (``icon_tpu.models.smplx.body``; reference
lib/smplx/body_models.py).

``BodyModel`` is an ``nn.Module`` whose model arrays are buffers (so
``.to(device)`` moves them) and whose ``faces``, ``parents``,
``model_type``, ``num_betas`` and ``flat_hand_mean`` are static attributes.
``forward`` covers the JAX model's every branch: SMPL (23-joint body,
``betas``), SMPL-X (body + jaw + eyes + hands, the expression space,
PCA-compressed hand poses with the hand mean), ``extra_pose``, ``scale``,
``transl`` and the identity-rotation pad of ``pose2rot=False``.

SMPL-X full-pose joint order: ``global_orient(1) | body(21) | jaw(1) |
leye(1) | reye(1) | left_hand(15) | right_hand(15)`` = 55 joints.

``load_body_model`` reads the standard release files (.pkl or .npz) with
numpy; ``synthetic_body_model`` and ``synthetic_smplx_model`` draw the JAX
package's seeded test models, array for array.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from icon_tpu_torch.models.smplx.lbs import lbs

# SMPL-X body layout constants (body_models.py NUM_BODY_JOINTS etc.)
SMPLX_NUM_BODY_JOINTS = 21
SMPLX_NUM_HAND_JOINTS = 15
SMPLX_JAW, SMPLX_LEYE, SMPLX_REYE = 22, 23, 24
SMPLX_LHAND_START = 25                     # joints 25..39
SMPLX_RHAND_START = 40                     # joints 40..54

_ARRAYS = ("v_template", "shapedirs", "posedirs", "J_regressor",
           "lbs_weights", "expr_dirs", "hands_components_l",
           "hands_components_r", "hands_mean_l", "hands_mean_r")


class BodyModel(nn.Module):
    """SMPL-family model. Buffers: ``v_template [V, 3]``, ``shapedirs
    [V, 3, n_betas]``, ``posedirs [9*J, V*3]``, ``J_regressor [J+1, V]``,
    ``lbs_weights [V, J+1]``, and for SMPL-X ``expr_dirs [V, 3, n_expr]``,
    ``hands_components_{l,r} [n_pca, 45]``, ``hands_mean_{l,r} [45]`` (None
    where the model has none)."""

    def __init__(self, v_template, shapedirs, posedirs, J_regressor,
                 lbs_weights, faces: np.ndarray, parents: Sequence[int],
                 model_type: str = "smpl", num_betas: int = 10,
                 expr_dirs=None, hands_components_l=None,
                 hands_components_r=None, hands_mean_l=None,
                 hands_mean_r=None, flat_hand_mean: bool = False):
        super().__init__()
        values = (v_template, shapedirs, posedirs, J_regressor, lbs_weights,
                  expr_dirs, hands_components_l, hands_components_r,
                  hands_mean_l, hands_mean_r)
        for name, value in zip(_ARRAYS, values):
            self.register_buffer(name, None if value is None else
                                 torch.from_numpy(np.array(value,
                                                           np.float32)))
        self.faces = np.asarray(faces)
        self.parents: Tuple[int, ...] = tuple(int(p) for p in parents)
        self.model_type = model_type
        self.num_betas = num_betas
        self.flat_hand_mean = flat_hand_mean

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    def _hand_pose(self, pose: Optional[torch.Tensor], B: int,
                   side: str) -> torch.Tensor:
        """A hand pose as 45-dof axis-angle: PCA coefficients expand with the
        hand components; the hand mean is added unless ``flat_hand_mean``."""
        comps = self.hands_components_l if side == "l" \
            else self.hands_components_r
        mean = self.hands_mean_l if side == "l" else self.hands_mean_r
        if pose is None:
            full = self.v_template.new_zeros((B, SMPLX_NUM_HAND_JOINTS * 3))
        else:
            pose = pose.reshape(B, -1)
            if pose.shape[-1] == SMPLX_NUM_HAND_JOINTS * 3:
                full = pose
            else:                                    # PCA coefficients
                if comps is None:
                    raise ValueError("the model has no hand PCA components")
                full = pose @ comps[:pose.shape[-1]]
        if mean is not None and not self.flat_hand_mean:
            full = full + mean[None]
        return full

    def forward(self, betas: Optional[torch.Tensor] = None,
                global_orient: Optional[torch.Tensor] = None,
                body_pose: Optional[torch.Tensor] = None,
                transl: Optional[torch.Tensor] = None,
                pose2rot: bool = True,
                extra_pose: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                expression: Optional[torch.Tensor] = None,
                jaw_pose: Optional[torch.Tensor] = None,
                leye_pose: Optional[torch.Tensor] = None,
                reye_pose: Optional[torch.Tensor] = None,
                left_hand_pose: Optional[torch.Tensor] = None,
                right_hand_pose: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(verts ``[B, V, 3]``, joints ``[B, J+1, 3]``).

        ``body_pose``: ``[B, J_body*3]`` axis-angle (rotation matrices
        flattened when not ``pose2rot``). For SMPL-X the face and hand
        arguments follow the reference model: hand poses may be PCA
        coefficients (up to the stored components) or 45-dof axis-angle.
        ``extra_pose`` appends raw dofs after ``body_pose`` and excludes the
        named face/hand arguments. Missing joints get zero axis-angle, or
        identity rotations when not ``pose2rot``."""
        nj = self.num_joints
        ref = self.v_template
        B = 1
        for a in (betas, global_orient, body_pose, expression):
            if a is not None:
                B = max(B, a.shape[0])
        if betas is None:
            betas = ref.new_zeros((B, self.num_betas))
        if global_orient is None:
            global_orient = ref.new_zeros((B, 3))
        pose_parts = [global_orient]
        if body_pose is not None:
            pose_parts.append(body_pose.reshape(B, -1))
        elif pose2rot:
            n_body = SMPLX_NUM_BODY_JOINTS if self.model_type == "smplx" \
                else nj - 1
            pose_parts.append(ref.new_zeros((B, n_body * 3)))

        has_face_hands = any(p is not None for p in (
            jaw_pose, leye_pose, reye_pose, left_hand_pose, right_hand_pose))
        if self.model_type == "smplx" and pose2rot and (has_face_hands or
                                                        extra_pose is None):
            if extra_pose is not None:
                raise ValueError(
                    "extra_pose conflicts with the named face/hand poses")
            for p in (jaw_pose, leye_pose, reye_pose):
                pose_parts.append(ref.new_zeros((B, 3)) if p is None
                                  else p.reshape(B, 3))
            pose_parts.append(self._hand_pose(left_hand_pose, B, "l"))
            pose_parts.append(self._hand_pose(right_hand_pose, B, "r"))
        elif extra_pose is not None:
            pose_parts.append(extra_pose.reshape(B, -1))
        pose = torch.cat(pose_parts, dim=1)
        dof = 9 if not pose2rot else 3      # rotation matrices vs axis-angle
        missing = nj * dof - pose.shape[1]
        if missing > 0:
            if pose2rot:
                pad = ref.new_zeros((B, missing))
            else:                            # identity rotations
                pad = torch.eye(3, dtype=ref.dtype, device=ref.device
                                ).reshape(-1).repeat(B, missing // 9)
            pose = torch.cat([pose, pad], dim=1)

        nb = betas.shape[-1]
        shapedirs = self.shapedirs[..., :nb]
        if expression is not None and self.expr_dirs is not None:
            ne = expression.shape[-1]
            shapedirs = torch.cat([shapedirs, self.expr_dirs[..., :ne]],
                                  dim=-1)
            betas = torch.cat([betas, expression.expand(B, ne)], dim=-1)
        verts, joints = lbs(betas, pose, self.v_template, shapedirs,
                            self.posedirs, self.J_regressor, self.parents,
                            self.lbs_weights, pose2rot=pose2rot)
        if scale is not None:
            s = scale[:, None, :] if scale.ndim == 2 else scale
            verts = verts * s
            joints = joints * s
        if transl is not None:
            verts = verts + transl[:, None, :]
            joints = joints + transl[:, None, :]
        return verts, joints


def _to_np(x) -> np.ndarray:
    """Possibly chumpy / scipy-sparse entries -> dense numpy."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "r"):          # chumpy
        return np.asarray(x.r)
    return np.asarray(x)


# SMPL-X release files keep 300 shape columns, then the expression columns
SMPLX_SHAPE_SPACE_DIM = 300


def load_body_model(path: str, model_type: Optional[str] = None,
                    num_betas: int = 10,
                    num_expression_coeffs: int = 10,
                    kid_template_path: Optional[str] = None,
                    age: str = "adult",
                    v_template: Optional[np.ndarray] = None,
                    flat_hand_mean: bool = False) -> BodyModel:
    """Load a SMPL/SMPL-X asset file (.pkl or .npz). ``kid_template_path``
    with ``age == 'kid'`` appends the kid blend shape (v_template_kid -
    v_template) as one more beta direction, as the reference does."""
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")

    if model_type is None:
        base = os.path.basename(path).lower()
        for t in ("smplx", "smplh", "mano", "flame"):
            if base.startswith(t):
                model_type = t
                break
        else:
            model_type = "smpl"

    vt = _to_np(data["v_template"]).astype(np.float32) \
        if v_template is None else np.asarray(v_template, np.float32)
    shapedirs_all = _to_np(data["shapedirs"]).astype(np.float32)
    expr_dirs = None
    # SMPL-X and FLAME store 300 shape columns, then the expression columns
    if model_type in ("smplx", "flame") and \
            shapedirs_all.shape[-1] > SMPLX_SHAPE_SPACE_DIM:
        expr_dirs = shapedirs_all[
            :, :, SMPLX_SHAPE_SPACE_DIM:
            SMPLX_SHAPE_SPACE_DIM + num_expression_coeffs]
    shapedirs = shapedirs_all[:, :, :num_betas]
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    # reference layout: posedirs [V, 3, P] -> [P, V*3]
    if posedirs.ndim == 3:
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    J_regressor = _to_np(data["J_regressor"]).astype(np.float32)
    weights = _to_np(data["weights"]).astype(np.float32)
    faces = _to_np(data.get("f", data.get("faces"))).astype(np.int32)
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = 0

    hc_l = hc_r = hm_l = hm_r = None
    if "hands_componentsl" in data:
        hc_l = _to_np(data["hands_componentsl"]).astype(np.float32)
        hc_r = _to_np(data["hands_componentsr"]).astype(np.float32)
        hm_l = _to_np(data["hands_meanl"]).astype(np.float32)
        hm_r = _to_np(data["hands_meanr"]).astype(np.float32)
    elif "hands_components" in data:   # MANO single-hand PCA
        hc_l = hc_r = _to_np(data["hands_components"]).astype(np.float32)
        hm_l = hm_r = _to_np(data["hands_mean"]).astype(np.float32)

    if age == "kid" and kid_template_path:
        v_kid = np.load(kid_template_path)
        v_kid = v_kid - np.mean(v_kid, axis=0, keepdims=True) + \
            np.mean(vt, axis=0, keepdims=True)
        kid_dir = (v_kid - vt)[:, :, None].astype(np.float32)
        shapedirs = np.concatenate(
            [shapedirs[:, :, :num_betas], kid_dir], axis=-1)
        num_betas = num_betas + 1

    return BodyModel(vt, shapedirs, posedirs, J_regressor, weights, faces,
                     parents, model_type, num_betas, expr_dirs=expr_dirs,
                     hands_components_l=hc_l, hands_components_r=hc_r,
                     hands_mean_l=hm_l, hands_mean_r=hm_r,
                     flat_hand_mean=flat_hand_mean)


def synthetic_body_model(n_verts: int = 128, n_joints: int = 4,
                         n_betas: int = 10, seed: int = 0) -> BodyModel:
    """A random but consistent small SMPL-layout model (no real assets)."""
    rng = np.random.RandomState(seed)
    V, J = n_verts, n_joints
    v_template = rng.randn(V, 3).astype(np.float32) * 0.3
    shapedirs = rng.randn(V, 3, n_betas).astype(np.float32) * 0.01
    posedirs = (rng.randn(9 * (J - 1), V * 3) * 0.001).astype(np.float32)
    J_regressor = rng.rand(J, V).astype(np.float32)
    J_regressor /= J_regressor.sum(1, keepdims=True)
    w = rng.rand(V, J).astype(np.float32) ** 2
    w /= w.sum(1, keepdims=True)
    faces = np.stack([np.arange(V - 2), np.arange(1, V - 1),
                      np.arange(2, V)], axis=1).astype(np.int32)
    parents = tuple([0] + list(range(J - 1)))
    return BodyModel(v_template, shapedirs, posedirs, J_regressor, w, faces,
                     parents, "smpl", n_betas)


def synthetic_smplx_model(subdiv: int = 3, n_betas: int = 10,
                          n_expr: int = 10, n_pca: int = 12,
                          seed: int = 0) -> BodyModel:
    """A watertight "SMPL-X": the synthetic body's icosphere template with
    the full 55-joint SMPL-X pose layout, expression dirs and hand PCA, so
    that every branch of ``forward`` runs (subdiv 5: 10,242 vertices, 20,480
    faces, posedirs ``[486, 30,726]``)."""
    from icon_tpu.utils.synthetic import synthetic_body
    rng = np.random.RandomState(seed)
    v, faces = synthetic_body(subdiv=subdiv)
    V = len(v)
    J = 55
    shapedirs = rng.randn(V, 3, n_betas).astype(np.float32) * 0.01
    expr_dirs = rng.randn(V, 3, n_expr).astype(np.float32) * 0.003
    posedirs = (rng.randn(9 * (J - 1), V * 3) * 0.0005).astype(np.float32)
    J_regressor = rng.rand(J, V).astype(np.float32) ** 4
    J_regressor /= J_regressor.sum(1, keepdims=True)
    w = rng.rand(V, J).astype(np.float32) ** 4
    w /= w.sum(1, keepdims=True)
    # SMPL-X kinematic tree shape: a chain with hand/face branches off late
    parents = [0] * J
    for j in range(1, SMPLX_NUM_BODY_JOINTS + 1):
        parents[j] = j - 1
    for j in (SMPLX_JAW, SMPLX_LEYE, SMPLX_REYE):
        parents[j] = 12
    for j in range(SMPLX_LHAND_START, SMPLX_LHAND_START + 15):
        parents[j] = 20 if j == SMPLX_LHAND_START else j - 1
    for j in range(SMPLX_RHAND_START, SMPLX_RHAND_START + 15):
        parents[j] = 21 if j == SMPLX_RHAND_START else j - 1
    hc = rng.randn(n_pca, 45).astype(np.float32) * 0.1
    hm = (rng.randn(45) * 0.05).astype(np.float32)
    return BodyModel(v, shapedirs, posedirs, J_regressor, w, faces, parents,
                     "smplx", n_betas, expr_dirs=expr_dirs,
                     hands_components_l=hc,
                     hands_components_r=hc[::-1].copy(),
                     hands_mean_l=hm, hands_mean_r=-hm)
