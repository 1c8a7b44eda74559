"""Separable box smoothing (``icon_tpu.ops.voxelize.smooth_conv3d``, the
reference's SmoothConv3D, lib/common/seg3d_utils.py:169). The engine uses it
to dilate boundary voxels. Semantic voxelization (PaMIR) is not ported
(ROADMAP Queue A item 9)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _blur_axis_pad(vol: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Normalized box blur along one axis with zero padding."""
    half = k // 2
    n = vol.shape[axis]
    pad = [0, 0] * vol.ndim
    j = vol.ndim - 1 - (axis % vol.ndim)     # F.pad lists the last axis first
    pad[2 * j] = pad[2 * j + 1] = half
    vp = F.pad(vol, pad)
    out = torch.zeros_like(vol)
    for off in range(k):
        out = out + vp.narrow(axis, off, n)
    return out / k


def smooth_conv3d(vol: torch.Tensor, k: int) -> torch.Tensor:
    """Separable normalized k-box filter over the last three axes of
    ``[..., D, H, W]``, zero padded."""
    for axis in (-3, -2, -1):
        vol = _blur_axis_pad(vol, axis, k)
    return vol
