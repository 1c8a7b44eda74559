"""Resizing with torch ``align_corners=True`` semantics
(``icon_tpu.ops.resize``).

The JAX package writes these as separable interpolation matrices because
``jax.image.resize`` has no align_corners mode; here they are
``F.interpolate`` itself, in PyTorch's channel-first layout.
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


def resize3d_trilinear_align_corners(x: torch.Tensor,
                                     out_dhw: Sequence[int]) -> torch.Tensor:
    """Trilinear align_corners resize of ``[B, C, D, H, W]`` to ``out_dhw``.

    On the engine's (r -> 2r - 1) ladder every weight is 0, 1/2 or 1, so a
    0/1 indicator upsamples exactly (multiples of 1/8) whatever the order
    of the sums."""
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear",
                         align_corners=True)
