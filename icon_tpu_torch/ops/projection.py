"""Calibration-matrix projections of 3D points (``icon_tpu.ops.projection``;
reference lib/net/geometry.py:46-82). Points are channel-last ``[B, N, 3]``,
as in the JAX package.
"""

from __future__ import annotations

import torch


def _homogeneous(points: torch.Tensor,
                 calibrations: torch.Tensor) -> torch.Tensor:
    rot = calibrations[:, :3, :3]
    trans = calibrations[:, :3, 3]
    return torch.matmul(points, rot.transpose(1, 2)) + trans[:, None, :]


def orthogonal(points: torch.Tensor,
               calibrations: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3]`` points through ``[B, 3or4, 4]`` calibrations ->
    ``[B, N, 3]`` xyz in normalized image coordinates."""
    return _homogeneous(points, calibrations)


def perspective(points: torch.Tensor,
                calibrations: torch.Tensor) -> torch.Tensor:
    """Perspective projection: ``[B, N, 3]`` = (x/z, y/z, z) of the points
    through ``[B, 3or4, 4]`` calibrations."""
    homo = _homogeneous(points, calibrations)
    return torch.cat([homo[..., :2] / homo[..., 2:3], homo[..., 2:3]], -1)


def project(points: torch.Tensor, calibrations: torch.Tensor,
            mode: str = "orthogonal") -> torch.Tensor:
    if mode == "orthogonal":
        return orthogonal(points, calibrations)
    if mode == "perspective":
        return perspective(points, calibrations)
    raise ValueError(f"unknown projection mode {mode!r}")
