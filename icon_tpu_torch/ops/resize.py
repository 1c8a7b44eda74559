"""Resizing with torch ``align_corners=True`` semantics
(``icon_tpu.ops.resize``).

The JAX package writes these as separable interpolation matrices because
``jax.image.resize`` has no align_corners mode; here they are
``F.interpolate`` itself, in PyTorch's channel-first layout, but for the
recon engine's 2x trilinear upsample, which follows the JAX package's
rounding.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def upsample2x_bicubic(x: torch.Tensor) -> torch.Tensor:
    """2x bicubic (a = -0.75, the Keys kernel torch uses), align_corners, on
    ``[B, C, H, W]``."""
    return F.interpolate(x, scale_factor=2, mode="bicubic",
                         align_corners=True)


def resize2d_bilinear_align_corners(x: torch.Tensor,
                                    out_hw: Sequence[int]) -> torch.Tensor:
    """Bilinear align_corners resize of ``[B, C, H, W]`` to ``out_hw`` (the
    JAX package's ``resize_align_corners(..., "linear")``, which HRNet's
    '-conv' head climbs by)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def resize3d_trilinear_align_corners(x: torch.Tensor,
                                     out_dhw: Sequence[int]) -> torch.Tensor:
    """Trilinear align_corners resize of ``[B, C, D, H, W]`` to ``out_dhw``.

    On the engine's (r -> 2r - 1) ladder every weight is 0, 1/2 or 1: there
    the resize is separable midpoints in the JAX package's order (D, then H,
    then W; each new sample ``0.5 a + 0.5 b`` rounded once), so its values
    equal the JAX package's bit for bit (an interpolation of exactly 0.5
    stays 0.5, which the recon engine's exact mode compares with its
    balance). Other sizes take ``F.interpolate``."""
    if all(o == 2 * n - 1 for o, n in zip(out_dhw, x.shape[2:])):
        for dim in (2, 3, 4):
            x = _midpoints(x, dim)
        return x
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear",
                         align_corners=True)


def _midpoints(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``0.5 x[i] + 0.5 x[i + 1]`` between neighbours along
    ``dim`` (n -> 2n - 1)."""
    n = x.shape[dim]
    if n == 1:
        return x
    a, b = x.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1)
    pairs = torch.stack([a, 0.5 * a + 0.5 * b], dim + 1).flatten(dim, dim + 1)
    return torch.cat([pairs, x.narrow(dim, n - 1, 1)], dim)
