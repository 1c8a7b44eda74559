"""Pixel-aligned feature sampling (``icon_tpu.ops.grid_sample``): bilinear
over images, trilinear over volumes.

``F.grid_sample`` with ``align_corners=True`` and zero padding is the
reference's own convention (lib/net/geometry.py:21-43); the JAX package
reimplements it as gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``feat [B, H, W, C]`` at ``uv [B, N, 2]`` in
    [-1, 1] (``uv[..., 0]`` indexes W, ``uv[..., 1]`` indexes H).
    Returns ``[B, N, C]``."""
    out = F.grid_sample(feat.permute(0, 3, 1, 2), uv[:, :, None, :].to(
        feat.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=True)                               # [B, C, N, 1]
    return out[..., 0].transpose(1, 2)


def grid_sample_3d(vol: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``vol [B, D, H, W, C]`` at ``xyz [B, N, 3]`` in
    [-1, 1] (``xyz[..., 0]`` indexes W, ``xyz[..., 1]`` H, ``xyz[..., 2]``
    D). Returns ``[B, N, C]``."""
    out = F.grid_sample(vol.permute(0, 4, 1, 2, 3), xyz[:, :, None, None, :]
                        .to(vol.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0, 0].transpose(1, 2)                 # [B, C, N, 1, 1]


def index(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The PIFu ``index`` op (reference lib/net/geometry.py:21): 2D
    coordinates sample an image, 3D ones a volume."""
    if uv.shape[-1] == 2:
        return grid_sample_2d(feat, uv)
    if uv.shape[-1] == 3:
        return grid_sample_3d(feat, uv)
    raise ValueError(f"uv last dim must be 2 or 3, got {tuple(uv.shape)}")
