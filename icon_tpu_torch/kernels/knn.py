"""k nearest body vertices per point: the CUDA kernel and its plain twin.

:func:`nearest_vertices_kernel` is the wrapper the main path calls. A CUDA
tensor launches ``csrc/knn.cu`` (the key product on the tensor cores, its
operands split into TF32 parts, as a filter; exact float32 rescoring;
top-k by (key, index), so ties go to the lowest index) or raises; a CPU
tensor takes :func:`nearest_vertices_plain`, the same function in plain
PyTorch.
:func:`key_margin` restates the kernel's filter margin. ``launches`` counts
kernel launches, so a run can show that the main path went through the
kernel.
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


# The filter's margin: |k_tc - key| <= C * T + A_ABS (csrc/knn.cu's note,
# kMarginC and kMarginAbs there; keep the two in step)
MARGIN_C = 2.0 ** -15
MARGIN_ABS = 2.0 ** -96


def key_margin(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """``[N, V]`` bound on how far the kernel's tensor-core filter key of
    (point, vertex) may lie from the float32 key: ``C * (2 (|px x| + |py
    y| + |pz z|) + w) + A_ABS`` with ``w = |v|^2``. The filter splits A =
    [p, 1] and B = [-2v, w] into TF32 parts (``a = ah + al``, by
    truncation or to nearest) and sums ``ah.bl + al.bh + ah.bh`` on the
    tensor cores (derived in csrc/knn.cu's note). A pair whose filter key
    exceeds a row's k-th exact key by more than this cannot be among the
    row's k. Computed in float64."""
    w = squared_norms(verts).double()
    t = 2.0 * (points.double().abs() @ verts.double().abs().T) + w[None]
    return MARGIN_C * t + MARGIN_ABS


def squared_norms(verts: torch.Tensor) -> torch.Tensor:
    """``|v|^2`` in float32 as the kernel rounds it: ``(x*x + y*y) +
    z*z``, each step rounded."""
    x, y, z = verts.unbind(-1)
    return (x * x + y * y) + z * z


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
    vn = squared_norms(verts)
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
    idx = torch.empty((n, k), dtype=torch.int32, device=points.device)
    key = torch.empty((n, k), dtype=torch.float32, device=points.device)
    _launch(points, verts, idx, key)
    if n:
        launches += 1
    return idx, key


def _launch(points: torch.Tensor, verts: torch.Tensor, idx: torch.Tensor,
            key: torch.Tensor) -> None:
    """One kernel launch on caller-owned ``idx`` [N, k] int32 and ``key``
    [N, k] f32 (checked by the caller), on the current stream; counts
    nothing. :func:`nearest_vertices_kernel` and the kernel's timing use
    it."""
    lib = _load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icon_knn_f32(points.data_ptr(), verts.data_ptr(),
                               points.shape[0], verts.shape[0],
                               idx.shape[1], idx.data_ptr(), key.data_ptr(),
                               stream)
    if err != 0:
        msg = lib.icon_cuda_error_string(err).decode()
        raise RuntimeError(f"icon_knn_f32 launch failed: {msg} ({err})")
