"""Semantic voxelization of the body for PaMIR and separable box smoothing
(``icon_tpu.ops.voxelize``), in plain PyTorch.

:func:`voxelize_semantic` is the JAX package's replacement for the
reference's ``voxelize_cuda`` extension (lib/net/voxelize.py:17-61): each
vertex splats its 3-channel semantic code into a ``res^3`` volume with
trilinear weights (:func:`voxel_splat_plain`), then both accumulators are
box-smoothed and the codes normalized by the weights
(:func:`box_smooth3d_plain`). These are the plain versions of the kernels
in ``icon_tpu_torch/kernels/voxelize.py``, whose wrapper the network calls.
:func:`smooth_conv3d` (the reference's SmoothConv3D,
lib/common/seg3d_utils.py:169) also dilates the engine's boundary voxels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the eight trilinear corners (dx, dy, dz), in the JAX package's order
CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
           (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _blur_axis_pad(vol: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Normalized box blur along one axis with zero padding: each window
    summed from 0 in the order of its offsets, then divided by ``k``.

    The divisor is a tensor on ``vol``'s device: a CUDA tensor divided by a
    Python scalar is multiplied by its reciprocal instead, which can round
    differently from the division the kernel does."""
    half = k // 2
    n = vol.shape[axis]
    pad = [0, 0] * vol.ndim
    j = vol.ndim - 1 - (axis % vol.ndim)     # F.pad lists the last axis first
    pad[2 * j] = pad[2 * j + 1] = half
    vp = F.pad(vol, pad)
    out = torch.zeros_like(vol)
    for off in range(k):
        out = out + vp.narrow(axis, off, n)
    return out / torch.tensor(float(k), dtype=vol.dtype, device=vol.device)


def smooth_conv3d(vol: torch.Tensor, k: int) -> torch.Tensor:
    """Separable normalized k-box filter over the last three axes of
    ``[..., D, H, W]``, zero padded."""
    for axis in (-3, -2, -1):
        vol = _blur_axis_pad(vol, axis, k)
    return vol


def smooth_kernel_size(res: int, sigma: float) -> int:
    """The default box size: the total spread of the trilinear splat (~0.4
    cell) and the box (k / sqrt(12) cells) matches the reference gaussian's
    ``sigma`` at any resolution (11 at res 128 and sigma 0.05, 3 at res
    32)."""
    sig_cells = sigma * (res - 1) / 2.0
    k2 = max(12.0 * (sig_cells * sig_cells - 0.16) + 1.0, 1.0)
    return max(int(round(math.sqrt(k2))) | 1, 1)


def _corners(verts: torch.Tensor, res: int):
    """Per trilinear corner of ``verts [B, V, 3]``: (the flat voxel index
    ``[B, V]`` in ``[B * res^3]``, clamped; its weight ``[B, V]``, 0 where
    the corner lies outside the volume)."""
    B = verts.shape[0]
    n = res * res * res
    g = (verts + 1.0) * 0.5 * (res - 1)          # align_corners voxel coords
    base = torch.floor(g)
    frac = g - base
    base = base.to(torch.int64)
    first = (torch.arange(B, device=verts.device) * n)[:, None]
    for dx, dy, dz in CORNERS:
        idx = base + torch.tensor([dx, dy, dz], device=verts.device)
        w = (torch.abs((1 - dx) - frac[..., 0]) *
             torch.abs((1 - dy) - frac[..., 1]) *
             torch.abs((1 - dz) - frac[..., 2]))
        valid = torch.all((idx >= 0) & (idx < res), dim=-1)
        idx = torch.clamp(idx, 0, res - 1)
        lin = (idx[..., 2] * res + idx[..., 1]) * res + idx[..., 0] + first
        yield lin, torch.where(valid, w, torch.zeros_like(w))


def voxel_splat_plain(verts: torch.Tensor, codes: torch.Tensor,
                      res: int) -> torch.Tensor:
    """The splat's accumulators ``[B, res^3, C + 1]``: each vertex of
    ``verts [B, V, 3]`` (in [-1, 1], x indexing W, y H, z D) adds
    ``w * code`` (``codes [V, C]`` or ``[B, V, C]``) to channels 0..C-1 and
    its weight ``w`` to channel C of each of its eight trilinear corners,
    voxel ``(z * res + y) * res + x``; corners outside the volume add
    nothing."""
    B, V, _ = verts.shape
    if codes.ndim == 2:
        codes = codes[None].expand(B, V, codes.shape[-1])
    C = codes.shape[-1]
    acc = verts.new_zeros((B * res ** 3, C + 1))
    for lin, w in _corners(verts, res):
        w = w[..., None]
        acc = acc.index_add(0, lin.reshape(-1),
                            torch.cat([w * codes, w], -1).reshape(-1, C + 1))
    return acc.view(B, res ** 3, C + 1)


def splat_terms(verts: torch.Tensor, res: int) -> torch.Tensor:
    """``[B, res^3]`` int64: how many (vertex, corner) terms of non-zero
    weight each voxel's splat sums. Two summation orders of m non-negative
    terms differ by at most 2 m 2^-24 of the sum (the splat kernel's
    tolerance against the plain version)."""
    count = torch.zeros(verts.shape[0] * res ** 3, dtype=torch.int64,
                        device=verts.device)
    for lin, w in _corners(verts, res):
        count.index_add_(0, lin.reshape(-1), (w > 0).reshape(-1).long())
    return count.view(verts.shape[0], -1)


def box_smooth3d_plain(acc: torch.Tensor, k: int) -> torch.Tensor:
    """``acc [B, D, H, W, C + 1]`` box-smoothed over D, then H, then W
    (:func:`_blur_axis_pad`), and the first C channels divided by
    ``max(channel C, 1e-3)``: ``[B, D, H, W, C]``."""
    for axis in (1, 2, 3):
        acc = _blur_axis_pad(acc, axis, k)
    return acc[..., :-1] / torch.clamp(acc[..., -1:], min=1e-3)


def voxelize_semantic(verts: torch.Tensor, codes: torch.Tensor,
                      res: int = 128, sigma: float = 0.05,
                      smooth_kernel: int = None) -> torch.Tensor:
    """Splat per-vertex semantic codes into a ``res^3`` volume, in plain
    PyTorch (differentiable by autograd).

    Args:
      verts: ``[B, V, 3]`` vertices in [-1, 1] (calib space; y-up).
      codes: ``[V, 3]`` or ``[B, V, 3]`` semantic vertex codes.
      res: volume resolution (128 in the reference).
      sigma: gaussian splat stddev in [-1, 1] units (0.05 reference).
      smooth_kernel: box size; :func:`smooth_kernel_size` by default.

    Returns ``[B, res, res, res, 3]`` indexed [z, y, x] (the reference's
    bzyxc -> bcdhw permute, lib/net/voxelize.py:137)."""
    k = smooth_kernel_size(res, sigma) if smooth_kernel is None \
        else smooth_kernel
    acc = voxel_splat_plain(verts, codes, res)
    return box_smooth3d_plain(
        acc.view(verts.shape[0], res, res, res, acc.shape[-1]), k)
