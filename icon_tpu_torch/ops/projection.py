"""Calibration-matrix projection of 3D points (``icon_tpu.ops.projection``).

Points are channel-last ``[B, N, 3]``, as in the JAX package. Only the
orthogonal mode is ported; ICON's published configs use it.
"""

from __future__ import annotations

import torch


def orthogonal(points: torch.Tensor,
               calibrations: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3]`` points through ``[B, 3or4, 4]`` calibrations ->
    ``[B, N, 3]`` xyz in normalized image coordinates."""
    rot = calibrations[:, :3, :3]
    trans = calibrations[:, :3, 3]
    return torch.matmul(points, rot.transpose(1, 2)) + trans[:, None, :]


def project(points: torch.Tensor, calibrations: torch.Tensor,
            mode: str = "orthogonal") -> torch.Tensor:
    if mode == "orthogonal":
        return orthogonal(points, calibrations)
    if mode == "perspective":
        raise NotImplementedError(
            "perspective projection is not ported (ROADMAP Queue A item 1)")
    raise ValueError(f"unknown projection mode {mode!r}")
