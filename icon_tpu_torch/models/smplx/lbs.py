"""Linear blend skinning (``icon_tpu.models.smplx.lbs``; reference
lib/smplx/lbs.py).

Plain differentiable tensor ops; the kinematic chain is unrolled over the
(static, <= 55) joint count as in the JAX function, one batched 4x4 product
per joint.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def batch_rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8
                    ) -> torch.Tensor:
    """Axis-angle ``[N, 3]`` -> rotation matrices ``[N, 3, 3]``
    (lbs.py:299-347)."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=1, keepdim=True)
    rot_dir = rot_vecs / angle

    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]

    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1 - cos) * (K @ K)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor
                 ) -> torch.Tensor:
    """``[B, n]`` x ``[V, 3, n]`` -> per-vertex displacement ``[B, V, 3]``."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor
                    ) -> torch.Tensor:
    """``[J, V]`` x ``[B, V, 3]`` -> ``[B, J, 3]``."""
    return torch.einsum("jv,bvk->bjk", J_regressor, vertices)


def _make_tf(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` + ``[..., 3]`` -> homogeneous ``[..., 4, 4]``."""
    pad = R.new_zeros(R.shape[:-2] + (1, 4))
    pad[..., 0, 3] = 1.0
    Rt = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([Rt, pad], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: Sequence[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics (lbs.py:349-419): ``rot_mats [B, J, 3, 3]`` local
    joint rotations, ``joints [B, J, 3]`` rest-pose joints, ``parents``
    (``parents[0]``, the root's, is ignored) -> (posed joints ``[B, J, 3]``,
    relative transforms ``[B, J, 4, 4]``)."""
    parents = [int(p) for p in parents]
    J = joints.shape[1]
    rel_joints = torch.cat(
        [joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], dim=1)

    local = _make_tf(rot_mats, rel_joints)               # [B, J, 4, 4]

    world = [local[:, 0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[:, j])
    world = torch.stack(world, dim=1)                    # [B, J, 4, 4]

    posed_joints = world[..., :3, 3]

    # A = world . translate(-rest_joint): subtract the rotated rest joints
    joints_h = torch.cat([joints, joints.new_zeros(joints.shape[:-1] + (1,))],
                         dim=-1)
    corr = torch.einsum("bjmn,bjn->bjm", world, joints_h)  # [B, J, 4]
    rel_tf = world - torch.cat(
        [world.new_zeros(world.shape[:-1] + (3,)), corr[..., None]], dim=-1)
    return posed_joints, rel_tf


def lbs(betas: torch.Tensor, pose: torch.Tensor, v_template: torch.Tensor,
        shapedirs: torch.Tensor, posedirs: torch.Tensor,
        J_regressor: torch.Tensor, parents: Sequence[int],
        lbs_weights: torch.Tensor, pose2rot: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMPL forward (lbs.py:152-253): ``betas [B, n]``, ``pose [B, (J+1)*3]``
    axis-angle (or ``[B, J+1, 3, 3]`` rotation matrices, flattened or not,
    when not ``pose2rot``), ``v_template [V, 3]``, ``shapedirs [V, 3, n]``,
    ``posedirs [9*J, V*3]``, ``J_regressor [J+1, V]``, ``lbs_weights
    [V, J+1]`` -> (verts ``[B, V, 3]``, joints ``[B, J+1, 3]``)."""
    B = max(betas.shape[0], pose.shape[0])

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    J = vertices2joints(J_regressor, v_shaped)

    ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
    if pose2rot:
        rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    else:
        rot_mats = pose.reshape(B, -1, 3, 3)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    J_transformed, A = batch_rigid_transform(rot_mats, J, parents)

    T = torch.einsum("vj,bjmn->bvmn", lbs_weights, A)    # [B, V, 4, 4]

    v_h = torch.cat([v_posed, v_posed.new_ones(v_posed.shape[:-1] + (1,))],
                    dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", T, v_h)[..., :3]
    return verts, J_transformed
