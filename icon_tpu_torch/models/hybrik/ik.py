"""HybrIK's hybrid analytic-neural inverse kinematics
(``icon_tpu.models.hybrik.ik``; reference lib/hybrik/models/layers/smpl/
lbs.py:559-771, batch_inverse_kinematics_transform).

From predicted joint positions and per-bone twist angles (phi), the local
joint rotations: the root and every joint with several children solve an
orthogonal Procrustes problem over their children's offsets (an SVD with
the determinant fix); every other joint with a child is a swing, the
Rodrigues rotation taking the rest bone onto the predicted one, times a
twist by phi about the rest bone; a leaf keeps the identity. The loop runs
over the static kinematic tree, unrolled.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _rotation(axis: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """Rodrigues: the rotation about the unit ``axis [B, 3]`` by the angle
    of (``cos``, ``sin``), each ``[B, 1, 1]``."""
    K = _skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)[None]
    return eye + sin * K + (1.0 - cos) * (K @ K)


def _rodrigues_between(u: torch.Tensor, t: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """The rotation ``[B, 3, 3]`` taking the rest bone ``u [B, 3]`` onto
    the direction of ``t [B, 3]``."""
    un = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + eps)
    tn = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + eps)
    axis = torch.linalg.cross(un, tn, dim=-1)
    sin = torch.linalg.norm(axis, dim=-1, keepdim=True)
    cos = torch.sum(un * tn, dim=-1, keepdim=True)
    return _rotation(axis / (sin + eps), cos[..., None], sin[..., None])


def _twist_about(axis: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """The rotation about ``axis [B, 3]`` (normalized here) by the angle of
    (``cos``, ``sin``), each ``[B]``."""
    an = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + eps)
    return _rotation(an, cos[:, None, None], sin[:, None, None])


def _procrustes(targets: torch.Tensor,
                templates: torch.Tensor) -> torch.Tensor:
    """The rotation ``[B, 3, 3]`` best mapping ``templates`` onto
    ``targets`` (both ``[B, K, 3]``): U diag(1, 1, det(U V^T)) V^T of the
    SVD of their correlation (batch_get_pelvis_orient_svd)."""
    M = torch.einsum("bkc,bkd->bcd", targets, templates)
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], -1))
    return U @ D @ Vt


def children_map(parents: Sequence[int]) -> List[List[int]]:
    out: List[List[int]] = [[] for _ in parents]
    for j, p in enumerate(parents):
        if j > 0:
            out[p].append(j)
    return out


def hybrik_ik(pose_skeleton: torch.Tensor, phis: torch.Tensor,
              rest_pose: torch.Tensor,
              parents: Sequence[int]) -> torch.Tensor:
    """The local joint rotations ``[B, J, 3, 3]`` of the predicted joints
    ``pose_skeleton [B, J, 3]`` (root-relative), the twists ``phis [B,
    J - 1, 2]`` (cos, sin; normalized here), the template joints
    ``rest_pose [B, J, 3]`` and the tree ``parents``."""
    B, J, _ = pose_skeleton.shape
    parents = [int(p) for p in parents]
    kids = children_map(parents)
    par = [parents[i] for i in range(1, J)]
    rel_rest = torch.cat([rest_pose[:, :1],
                          rest_pose[:, 1:] - rest_pose[:, par]], dim=1)
    rel_pose = torch.cat([pose_skeleton[:, :1],
                          pose_skeleton[:, 1:] - pose_skeleton[:, par]],
                         dim=1)
    final = pose_skeleton - pose_skeleton[:, :1] + rest_pose[:, :1]
    phis = phis / (torch.linalg.norm(phis, dim=-1, keepdim=True) + 1e-8)
    eye = torch.eye(3, dtype=rest_pose.dtype, device=rest_pose.device
                    ).expand(B, 3, 3)

    R0 = _procrustes(rel_pose[:, kids[0]], rel_rest[:, kids[0]])
    chain, local, pos = [R0] * J, [R0] * J, [rel_rest[:, 0]] * J
    for i in range(1, J):
        p = parents[i]
        pos[i] = pos[p] + torch.einsum("bcd,bd->bc", chain[p],
                                       rel_rest[:, i])
        cs = kids[i]
        if not cs:                       # a leaf: the identity
            local[i], chain[i] = eye, chain[p]
            continue
        # the children's targets in the parent's accumulated frame
        tgt = torch.einsum("bdc,bkd->bkc", chain[p],
                           final[:, cs] - pos[i][:, None])
        if len(cs) > 1:                  # spine-like: Procrustes
            R = _procrustes(tgt, rel_rest[:, cs])
        else:
            u = rel_rest[:, cs[0]]
            R = _rodrigues_between(u, tgt[:, 0]) @ _twist_about(
                u, phis[:, i - 1, 0], phis[:, i - 1, 1])
        local[i] = R
        chain[i] = chain[p] @ R
    return torch.stack(local, dim=1)


def bone_alignment(rotmats: torch.Tensor, pose_skeleton: torch.Tensor,
                   rest_pose: torch.Tensor,
                   parents: Sequence[int]) -> torch.Tensor:
    """``[B]``: the least cosine, over the joints with one child, between
    the child's rest bone turned by the joint's accumulated rotation in
    ``rotmats [B, J, 3, 3]`` and the bone :func:`hybrik_ik` solved for (from
    the joint's posed rest position to the child's predicted one). 1 when
    every swing is exact, whatever twist the SVD chose where it is free
    (the Procrustes of a joint with one child)."""
    parents = [int(p) for p in parents]
    J = len(parents)
    kids = children_map(parents)
    par = [parents[i] for i in range(1, J)]
    rel_rest = torch.cat([rest_pose[:, :1],
                          rest_pose[:, 1:] - rest_pose[:, par]], dim=1)
    final = pose_skeleton - pose_skeleton[:, :1] + rest_pose[:, :1]
    chain, pos = [rotmats[:, 0]] * J, [rel_rest[:, 0]] * J
    cos = []
    for i in range(J):
        if i:
            p = parents[i]
            pos[i] = pos[p] + torch.einsum("bcd,bd->bc", chain[p],
                                           rel_rest[:, i])
            chain[i] = chain[p] @ rotmats[:, i]
        if len(kids[i]) == 1:
            c = kids[i][0]
            a = torch.einsum("bcd,bd->bc", chain[i], rel_rest[:, c])
            cos.append(torch.nn.functional.cosine_similarity(
                a, final[:, c] - pos[i], dim=-1))
    return torch.stack(cos, -1).min(-1).values
