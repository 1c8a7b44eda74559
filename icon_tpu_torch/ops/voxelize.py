"""Semantic voxelization of the body for PaMIR and separable box smoothing
(``icon_tpu.ops.voxelize``), in plain PyTorch.

:func:`voxelize_semantic` is the JAX package's replacement for the
reference's ``voxelize_cuda`` extension (lib/net/voxelize.py:17-61): each
vertex splats its 3-channel semantic code into a ``res^3`` volume with
trilinear weights (:func:`voxel_splat_plain`), then both accumulators are
box-smoothed and the codes normalized by the weights
(:func:`box_smooth3d_plain`). These are the plain versions of the kernels
in ``icon_tpu_torch/kernels/voxelize.py``, whose wrapper the network calls.
Their backward twins (:func:`box_smooth3d_bwd_plain`,
:func:`voxel_splat_bwd_plain`) are written out with the rules of JAX's
autodiff, not taken from torch's: ``d|u|/du`` is +1 at ``u = 0`` (torch's
``abs`` gives 0) and ``maximum(w, 1e-3)`` sends half of the gradient to
each side at a tie (torch's ``clamp`` sends all of it to ``w``).
:func:`smooth_conv3d` (the reference's SmoothConv3D,
lib/common/seg3d_utils.py:169) also dilates the engine's boundary voxels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from icon_tpu_torch.ops.constants import device_constant

# the eight trilinear corners (dx, dy, dz), in the JAX package's order
CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
           (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))
# the floor of the smoothed weight the codes are divided by
WEIGHT_FLOOR = 1e-3


def _blur_axis_pad(vol: torch.Tensor, axis: int, k: int,
                   mirrored: bool = False) -> torch.Tensor:
    """Normalized box blur along one axis with zero padding: each window
    summed from 0 in the order of its offsets, then divided by ``k``. The
    window's offsets run from ``-(k // 2)`` to ``k - 1 - k // 2``; with
    ``mirrored``, from ``-(k - 1 - k // 2)`` to ``k // 2`` (the adjoint of
    the blur, the same window for odd ``k``).

    The divisor is a tensor on ``vol``'s device (made once a device): a
    CUDA tensor divided by a Python scalar is multiplied by its reciprocal
    instead, which can round differently from the division the kernel
    does."""
    lo = k - 1 - k // 2 if mirrored else k // 2
    n = vol.shape[axis]
    pad = [0, 0] * vol.ndim
    j = vol.ndim - 1 - (axis % vol.ndim)     # F.pad lists the last axis first
    pad[2 * j], pad[2 * j + 1] = lo, k - 1 - lo
    vp = F.pad(vol, pad)
    out = torch.zeros_like(vol)
    for off in range(k):
        out = out + vp.narrow(axis, off, n)
    return out / device_constant(float(k), vol.dtype, vol.device)


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


def _corner_terms(verts: torch.Tensor, res: int):
    """Per trilinear corner ``(dx, dy, dz)`` of ``verts [B, V, 3]``, in
    :data:`CORNERS` order: (the flat voxel index ``[B, V]`` in ``[B *
    res^3]``, clamped; ``u``, the three ``[B, V]`` terms ``(1 - d_a) -
    frac_a`` whose absolute values make its weight; whether the corner
    lies inside the volume ``[B, V]``)."""
    B = verts.shape[0]
    n = res * res * res
    g = (verts + 1.0) * 0.5 * (res - 1)          # align_corners voxel coords
    base = torch.floor(g)
    frac = g - base
    base = base.to(torch.int64)
    first = (torch.arange(B, device=verts.device) * n)[:, None]
    for d in CORNERS:
        idx = base + torch.tensor(d, device=verts.device)
        u = [(1 - d[a]) - frac[..., a] for a in range(3)]
        valid = torch.all((idx >= 0) & (idx < res), dim=-1)
        idx = torch.clamp(idx, 0, res - 1)
        lin = (idx[..., 2] * res + idx[..., 1]) * res + idx[..., 0] + first
        yield lin, u, valid


def _corners(verts: torch.Tensor, res: int):
    """Per trilinear corner of ``verts [B, V, 3]``: (the flat voxel index
    ``[B, V]`` in ``[B * res^3]``, clamped; its weight ``[B, V]``, 0 where
    the corner lies outside the volume)."""
    for lin, u, valid in _corner_terms(verts, res):
        w = torch.abs(u[0]) * torch.abs(u[1]) * torch.abs(u[2])
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


def box_smooth3d_plain(acc: torch.Tensor, k: int,
                       keep_weight: bool = False):
    """``acc [B, D, H, W, C + 1]`` box-smoothed over D, then H, then W
    (:func:`_blur_axis_pad`), and the first C channels divided by
    ``max(channel C, 1e-3)``: ``[B, D, H, W, C]``. With ``keep_weight``,
    (that, the smoothed channel C ``[B, D, H, W]``), which the backward
    needs."""
    for axis in (1, 2, 3):
        acc = _blur_axis_pad(acc, axis, k)
    out = acc[..., :-1] / torch.clamp(acc[..., -1:], min=WEIGHT_FLOOR)
    return (out, acc[..., -1]) if keep_weight else out


def voxel_grad(g_out: torch.Tensor, out: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """The gradient ``[B, D, H, W, C + 1]`` of the smoothed accumulator
    (before the adjoint box) from the gradient ``g_out`` of the output
    ``out`` (both ``[B, D, H, W, C]``) and the smoothed weight ``weight
    [B, D, H, W]``. Per voxel, with ``m = max(weight, 1e-3)``: ``g_out /
    m`` for the codes; for the weight ``-(sum_c g_out_c out_c) / m``
    (``out_c = t_c / m``) where ``weight > 1e-3``, half of it at the tie
    ``weight == 1e-3`` (JAX's ``maximum``), 0 below."""
    floor = torch.tensor(WEIGHT_FLOOR, dtype=weight.dtype,
                         device=weight.device)
    m = torch.maximum(weight, floor)
    s = g_out[..., 0] * out[..., 0]
    for c in range(1, g_out.shape[-1]):
        s = s + g_out[..., c] * out[..., c]
    g_w = -(s / m)
    g_w = torch.where(weight > floor, g_w, torch.where(
        weight == floor, g_w * 0.5, torch.zeros_like(g_w)))
    return torch.cat([g_out / m[..., None], g_w[..., None]], -1)


def box_smooth3d_bwd_plain(g_out: torch.Tensor, out: torch.Tensor,
                           weight: torch.Tensor, k: int) -> torch.Tensor:
    """The gradient ``[B, D, H, W, C + 1]`` of :func:`box_smooth3d_plain`'s
    accumulator, from the gradient ``g_out`` of its output ``out`` (both
    ``[B, D, H, W, C]``) and the smoothed weight ``weight [B, D, H, W]``:
    :func:`voxel_grad`, then the adjoint box over D, then H, then W:
    :func:`_blur_axis_pad` ``mirrored``, each window summed from 0 in the
    order of its offsets and divided by ``k``."""
    g = voxel_grad(g_out, out, weight)
    for axis in (1, 2, 3):
        g = _blur_axis_pad(g, axis, k, mirrored=True)
    return g


def touched_rows(verts: torch.Tensor, res: int) -> torch.Tensor:
    """The rows of the splat's accumulators ``[B * res^3]`` that
    :func:`voxel_splat_bwd_plain` reads, sorted, each once (int64): the
    voxel of every trilinear corner of ``verts [B, V, 3]`` inside the
    volume, decided as the kernels decide it, on the float coordinate
    ``floor(g) + d`` in ``[0, res - 1]`` (no voxel for a NaN)."""
    B = verts.shape[0]
    g = (verts + 1.0) * 0.5 * (res - 1)
    base = torch.floor(g)
    first = torch.arange(B, device=verts.device)[:, None] * res ** 3
    rows = []
    for d in CORNERS:
        x = base + torch.tensor(d, dtype=verts.dtype, device=verts.device)
        inside = torch.all((x >= 0) & (x <= res - 1), dim=-1)
        i = torch.where(inside[..., None], x, torch.zeros_like(x)).long()
        lin = (i[..., 2] * res + i[..., 1]) * res + i[..., 0] + first
        rows.append(lin[inside])
    return torch.unique(torch.cat(rows))


def box_smooth3d_bwd_rows_plain(g_out: torch.Tensor, out: torch.Tensor,
                                weight: torch.Tensor, k: int,
                                rows: torch.Tensor) -> torch.Tensor:
    """:func:`box_smooth3d_bwd_plain` at ``rows`` (flat indices into ``[B
    * D * H * W]``) only: ``[len(rows), C + 1]``, each row from its own
    window, as the ``box_smooth3d_bwd`` kernel forms it: the
    :func:`voxel_grad` of the ``k x k x k`` voxels of the mirrored window
    (zero outside the volume); for each of its ``(y, x)`` columns the sum
    over z, from 0 in the order of the offsets, divided by ``k``; the sums
    of those over y, then over x, each divided by ``k``. The same
    operations in the same order as the dense version's, so the same
    bits."""
    B, D, H, W = out.shape[:4]
    lo = k - 1 - k // 2
    pad = (0, 0) + (lo, k - 1 - lo) * 3
    grad = F.pad(voxel_grad(g_out, out, weight), pad)
    rows = rows.to(device=out.device, dtype=torch.int64)
    x, rest = rows % W, rows // W
    y, rest = rest % H, rest // H
    z, b = rest % D, rest // D
    off = torch.arange(k, device=out.device)
    win = grad[b[:, None, None, None], (z[:, None] + off)[:, :, None, None],
               (y[:, None] + off)[:, None, :, None],
               (x[:, None] + off)[:, None, None, :]]     # [n, kz, ky, kx, C]
    kt = torch.tensor(float(k), dtype=out.dtype, device=out.device)
    for _ in range(3):                    # D, then H, then W
        s = torch.zeros_like(win[:, 0])
        for o in range(k):
            s = s + win[:, o]
        win = s / kt
    return win


def voxel_splat_bwd_plain(verts: torch.Tensor, codes: torch.Tensor,
                          g_acc: torch.Tensor, res: int,
                          codes_grad: bool = True):
    """The gradients (``verts``' ``[B, V, 3]``, ``codes``' of its shape or
    None without ``codes_grad``) of :func:`voxel_splat_plain` from its
    accumulators' gradient ``g_acc [B, res^3, C + 1]``, with JAX's rules.
    Per (vertex, corner) in :data:`CORNERS` order, where the corner lies
    inside the volume: its voxel's row ``G`` gives the weight's gradient
    ``g_w = sum_c G_c code_c + G_C`` and adds ``w G[:C]`` to the code's;
    the weight ``w = |u_x| |u_y| |u_z|`` (``u_a = (1 - d_a) - frac_a``)
    passes ``g_w`` on by the product rule with ``d|u|/du = +1`` at 0, so
    ``frac_a`` gets ``-sign(u_a) g_w`` times the other two factors.
    ``floor`` carries none: ``g_verts = g_frac * 0.5 (res - 1)``. Codes
    ``[V, C]`` sum their batch entries' gradients in the order of ``b``. A
    gather: each sum is taken in a fixed order."""
    B, V, _ = verts.shape
    C = g_acc.shape[-1] - 1
    cb = codes if codes.ndim == 3 else codes[None].expand(B, V, C)
    rows = g_acc.reshape(-1, C + 1)
    g_frac = torch.zeros_like(verts)
    g_code = torch.zeros_like(cb) if codes_grad else None
    for lin, u, valid in _corner_terms(verts, res):
        G = rows[lin]                                # [B, V, C + 1]
        zero = torch.zeros_like(u[0])
        a = [x.abs() for x in u]
        g_w = G[..., 0] * cb[..., 0]
        for c in range(1, C):
            g_w = g_w + G[..., c] * cb[..., c]
        g_w = torch.where(valid, g_w + G[..., C], zero)
        if codes_grad:
            w = torch.where(valid, a[0] * a[1] * a[2], zero)
            g_code = g_code + w[..., None] * G[..., :C]
        p = g_w * a[2]
        for i, t in enumerate((p * a[1], p * a[0], g_w * (a[0] * a[1]))):
            g_frac[..., i] = g_frac[..., i] - torch.where(u[i] >= 0, t, -t)
    g_verts = g_frac * (0.5 * (res - 1))
    if codes_grad and codes.ndim == 2:
        total = torch.zeros_like(codes)
        for b in range(B):
            total = total + g_code[b]
        g_code = total
    return g_verts, g_code


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
