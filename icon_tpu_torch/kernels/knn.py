"""k nearest body vertices per point: the CUDA kernel and its plain twin.

:func:`nearest_vertices_kernel` is the wrapper the main path calls. A CUDA
tensor launches ``csrc/knn.cu`` (exact top-k, ties to the lowest index) or
raises; a CPU tensor takes :func:`nearest_vertices_plain`, the same function
in plain PyTorch. ``launches`` counts kernel launches, so a run can show
that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

MAX_K = 8

launches = 0            # kernel launches since the last reset

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["knn.cu"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.icon_knn_f32.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
            lib.icon_knn_f32.restype = ci
            lib.icon_cuda_error_string.argtypes = [ci]
            lib.icon_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(points: torch.Tensor, verts: torch.Tensor, k: int) -> None:
    if points.ndim != 2 or points.shape[-1] != 3 or verts.ndim != 2 \
            or verts.shape[-1] != 3:
        raise ValueError(f"points [N, 3] and verts [V, 3] expected, got "
                         f"{tuple(points.shape)} and {tuple(verts.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if verts.shape[0] < k:
        raise ValueError(f"{verts.shape[0]} vertices cannot give {k} "
                         f"distinct nearest vertices")
    if points.device != verts.device:
        raise ValueError(f"points on {points.device}, verts on {verts.device}")


def nearest_vertices_plain(points: torch.Tensor, verts: torch.Tensor,
                           k: int = 2, point_chunk: int = 16384
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k in plain PyTorch: a chunked ``points @ verts.T`` product
    plus ``torch.topk(largest=False)``. Returns (idx [N, k] int32, ranking
    key |v|^2 - 2 p.v [N, k] f32), both sorted by key.

    Ties go to the lowest vertex index, as in the kernel: ``topk`` runs on
    int64 keys (the float's order-preserving int32 image, then the vertex
    index), which are unique. Mirror-symmetric bodies tie exactly at points
    on their symmetry planes."""
    _check(points, verts, k)
    vn = torch.sum(verts * verts, dim=-1)
    vid = torch.arange(verts.shape[0], device=verts.device)
    idx, key = [], []
    for p in torch.split(points, point_chunk):
        d2 = vn[None] - 2.0 * (p @ verts.T)
        bits = d2.view(torch.int32)
        bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)   # monotonic
        order = bits.to(torch.int64) * (1 << 32) + vid[None]
        ids = torch.topk(order, k, dim=1, largest=False, sorted=True).values
        ids = ids & 0xFFFFFFFF
        idx.append(ids.to(torch.int32))
        key.append(torch.gather(d2, 1, ids))
    if not idx:
        return (points.new_zeros((0, k), dtype=torch.int32),
                points.new_zeros((0, k)))
    return torch.cat(idx), torch.cat(key)


def nearest_vertices_kernel(points: torch.Tensor, verts: torch.Tensor,
                            k: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [N, k] int32, key [N, k] f32) of the k nearest vertices.

    CPU tensors take the plain version. CUDA tensors must be float32 and
    contiguous; they launch the kernel on the current stream or raise."""
    global launches
    _check(points, verts, k)
    if points.device.type == "cpu":
        return nearest_vertices_plain(points, verts, k)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    for name, t in (("points", points), ("verts", verts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, v = points.shape[0], verts.shape[0]
    if n >= 2 ** 31 // MAX_K or v >= 2 ** 31:
        raise ValueError(f"{n} points x {v} vertices exceed int32 indexing")
    lib = _load()
    idx = torch.empty((n, k), dtype=torch.int32, device=points.device)
    key = torch.empty((n, k), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icon_knn_f32(points.data_ptr(), verts.data_ptr(), n, v, k,
                               idx.data_ptr(), key.data_ptr(), stream)
    if err != 0:
        msg = lib.icon_cuda_error_string(err).decode()
        raise RuntimeError(f"icon_knn_f32 launch failed: {msg} ({err})")
    if n:
        launches += 1
    return idx, key
