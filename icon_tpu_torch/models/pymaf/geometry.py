"""Rotation and camera math of PyMAF (``icon_tpu.models.pymaf.geometry``;
reference lib/pymaf/utils/geometry.py)."""

from __future__ import annotations

import torch


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> ``[N, 3, 3]`` (Zhou et al. CVPR'19;
    Gram-Schmidt over the column pair, reference geometry.py:229-247)."""
    x = x.reshape(-1, 3, 2)
    a1 = x[:, :, 0]
    a2 = x[:, :, 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=1, keepdim=True),
                          min=1e-8)
    dot = torch.sum(b1 * a2, dim=1, keepdim=True)
    b2u = a2 - dot * b1
    b2 = b2u / torch.clamp(torch.linalg.norm(b2u, dim=1, keepdim=True),
                           min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_angle_axis(R: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``[N, 3, 3]`` -> ``[N, 3]`` axis-angle by the log map (the JAX
    package's, not the reference's quaternion path)."""
    trace = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    angle = torch.arccos(cos)
    axis = torch.stack([R[:, 2, 1] - R[:, 1, 2],
                        R[:, 0, 2] - R[:, 2, 0],
                        R[:, 1, 0] - R[:, 0, 1]], dim=1)
    sin = torch.sin(angle)[:, None]
    axis = axis / torch.clamp(2.0 * sin, min=eps)
    return axis * angle[:, None]


def identity_rot6d(n_joints: int) -> torch.Tensor:
    """``[n_joints * 6]`` 6D encoding of identity rotations (the mean-pose
    stand-in when ``smpl_mean_params.npz`` is absent); the entries
    interleave as ``[a1x, a2x, a1y, a2y, a1z, a2z]``, the layout of the
    (3, 2) reshape in :func:`rot6d_to_rotmat`."""
    one = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0])
    return one.repeat(n_joints)


def weak_perspective_projection(points: torch.Tensor, cam: torch.Tensor,
                                focal: float = 5000.0,
                                img_res: float = 224.0) -> torch.Tensor:
    """``points [B, N, 3]`` and ``cam [B, 3]`` (s, tx, ty) -> ``[B, N, 2]``
    in [-1, 1]: the reference's ``projection`` (geometry.py:246-264), a
    perspective camera at t = (tx, ty, 2 * focal / (img_res * s)) with focal
    5000 px on a 224 px image, normalized by img_res / 2 (not the
    s * (x + t) limit)."""
    s = cam[:, 0]
    tz = 2.0 * focal / (img_res * s + 1e-9)
    X = points[..., 0] + cam[:, None, 1]
    Y = points[..., 1] + cam[:, None, 2]
    Z = points[..., 2] + tz[:, None]
    xy = torch.stack([focal * X / Z, focal * Y / Z], dim=-1)
    return xy / (img_res / 2.0)
