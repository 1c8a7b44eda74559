"""Semantic voxelization: the CUDA kernels and their plain twins.

:func:`voxelize_semantic` is the wrapper PaMIR's query calls. A CUDA
tensor launches ``csrc/voxelize.cu``: ``voxel_splat`` (one thread per
vertex, float atomics into a zeroed ``[B, res^3, 4]`` accumulator) and
``box_smooth3d`` (three shared-memory passes over D, H and W, then the codes
over the weights), or raises; a CPU tensor takes the plain version
(``ops/voxelize.py``: :func:`voxel_splat_plain`,
:func:`box_smooth3d_plain`). The kernels are forward only: the backward
(training, ROADMAP A10) is not ported, so the wrapper raises on the card
when an input needs a gradient. ``launches_splat`` and ``launches_smooth``
count kernel launches (a ``box_smooth3d`` call is one count for its three
passes).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from icon_tpu_torch.ops.voxelize import (box_smooth3d_plain,
                                         smooth_kernel_size,
                                         voxel_splat_plain)

launches_splat = 0      # voxel_splat launches since the last reset
launches_smooth = 0     # box_smooth3d launches since the last reset

MAX_LINE = 2048         # csrc/voxelize.cu's kTileEntries: the longest axis

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["voxelize.cu"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.icon_voxel_splat.argtypes = [vp, vp] + [ci] * 4 + [vp, vp]
            lib.icon_voxel_splat.restype = ci
            lib.icon_box_smooth3d.argtypes = [vp] * 4 + [ci] * 5 + [vp]
            lib.icon_box_smooth3d.restype = ci
            lib.icon_voxel_error_string.argtypes = [ci]
            lib.icon_voxel_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.icon_voxel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _check_card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, expected a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{name} needs a gradient: the voxelize kernels are forward "
            "only (the backward is ROADMAP Queue A item A10)")


def voxel_splat(verts: torch.Tensor, codes: torch.Tensor,
                res: int) -> torch.Tensor:
    """The splat's accumulators ``[B, res^3, 4]`` (``w * code`` in 0..2,
    ``w`` in 3) of ``verts [B, V, 3]`` and ``codes [V, 3]`` or ``[B, V,
    3]``. CPU tensors take :func:`voxel_splat_plain`; CUDA tensors launch
    the kernel on the current stream or raise."""
    global launches_splat
    if verts.ndim != 3 or verts.shape[-1] != 3 or codes.ndim not in (2, 3) \
            or codes.shape[-2] != verts.shape[1]:
        raise ValueError(f"verts [B, V, 3] and codes [V, C] or [B, V, C] "
                         f"expected, got {tuple(verts.shape)} and "
                         f"{tuple(codes.shape)}")
    if verts.device.type == "cpu":
        return voxel_splat_plain(verts, codes, res)
    _check_card("verts", verts)
    _check_card("codes", codes)
    if codes.shape[-1] != 3 or (codes.ndim == 3 and
                                codes.shape[0] != verts.shape[0]):
        raise ValueError(f"the kernel takes 3 code channels per vertex, got "
                         f"codes {tuple(codes.shape)}")
    if codes.device != verts.device:
        raise ValueError(f"verts on {verts.device}, codes on {codes.device}")
    if not 1 <= res <= MAX_LINE:
        raise ValueError(f"res must be in [1, {MAX_LINE}], got {res}")
    B, V = verts.shape[:2]
    acc = torch.empty((B, res ** 3, 4), dtype=torch.float32,
                      device=verts.device)
    _splat(verts, codes, res, acc)
    launches_splat += 1
    return acc


def _splat(verts, codes, res: int, acc) -> None:
    """One ``voxel_splat`` (zeroing ``acc [B, res^3, 4]`` first) on
    caller-checked tensors, on the current stream; counts nothing."""
    lib = _load()
    B, V = verts.shape[:2]
    with torch.cuda.device(verts.device):
        err = lib.icon_voxel_splat(
            verts.data_ptr(), codes.data_ptr(), B, V, int(codes.ndim == 3),
            res, acc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "voxel_splat")


def box_smooth3d(acc: torch.Tensor, k: int) -> torch.Tensor:
    """``acc [B, D, H, W, C + 1]`` box-smoothed (size ``k``, zero padded)
    over D, H and W, the first C channels over ``max(channel C, 1e-3)``:
    ``[B, D, H, W, C]``. CPU tensors take :func:`box_smooth3d_plain`;
    CUDA tensors (C = 3) launch the kernel on the current stream or
    raise. ``acc`` is left as it is."""
    global launches_smooth
    if acc.ndim != 5:
        raise ValueError(f"acc [B, D, H, W, C + 1] expected, got "
                         f"{tuple(acc.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if acc.device.type == "cpu":
        return box_smooth3d_plain(acc, k)
    _check_card("acc", acc)
    if acc.shape[-1] != 4 or max(acc.shape[1:4]) > MAX_LINE:
        raise ValueError(f"the kernel takes 4 channels and axes of at most "
                         f"{MAX_LINE}, got {tuple(acc.shape)}")
    out = torch.empty(acc.shape[:4] + (3,), dtype=torch.float32,
                      device=acc.device)
    _smooth(acc, k, torch.empty_like(acc), torch.empty_like(acc), out)
    launches_smooth += 1
    return out


def _smooth(acc, k, tmp1, tmp2, out) -> None:
    """One ``box_smooth3d`` (three passes) on caller-checked tensors and
    scratch ``tmp1``, ``tmp2`` of ``acc``'s size, on the current stream;
    counts nothing."""
    lib = _load()
    B, D, H, W = acc.shape[:4]
    with torch.cuda.device(acc.device):
        err = lib.icon_box_smooth3d(
            acc.data_ptr(), tmp1.data_ptr(), tmp2.data_ptr(), out.data_ptr(),
            B, D, H, W, k, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "box_smooth3d")


def voxelize_semantic(verts: torch.Tensor, codes: torch.Tensor,
                      res: int = 128, sigma: float = 0.05,
                      smooth_kernel: Optional[int] = None) -> torch.Tensor:
    """``ops.voxelize.voxelize_semantic`` through the kernels:
    ``[B, res, res, res, 3]`` indexed [z, y, x]. CPU tensors take the plain
    version (differentiable); CUDA tensors launch ``voxel_splat`` and
    ``box_smooth3d`` or raise."""
    k = smooth_kernel_size(res, sigma) if smooth_kernel is None \
        else smooth_kernel
    acc = voxel_splat(verts, codes, res)
    return box_smooth3d(acc.view(verts.shape[0], res, res, res,
                                 acc.shape[-1]), k)
