"""Pixel-aligned bilinear feature sampling (``icon_tpu.ops.grid_sample``).

``F.grid_sample`` with ``align_corners=True`` and zero padding is the
reference's own convention; the JAX package reimplements it as gathers.
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
