"""Visibility-gated front/back feature selection (``icon_tpu.ops.select``,
reference ``feat_select``, lib/dataset/mesh_util.py:266-277)."""

from __future__ import annotations

import torch


def feat_select(feat: torch.Tensor, select: torch.Tensor) -> torch.Tensor:
    """``feat [B, N, 2*Cf]`` (front then back), ``select [B, N, 1]`` in
    {0, 1} -> ``[B, N, Cf]``: the front half where ``select > 0.5``."""
    dim = feat.shape[-1] // 2
    return torch.where(select > 0.5, feat[..., :dim], feat[..., dim:])
