"""Clustered fast winding numbers: the CUDA kernel and its plain twin.

:func:`fast_winding_kernel` is the wrapper ``ops/sdf_fast.py:fast_winding``
calls. A CUDA tensor launches ``csrc/winding.cu`` (a warp per point: the
lanes share the clusters, pick the m nearest by warp-wide minimums of
:func:`_order_keys`' key, and share the picked clusters' faces, read from
:func:`face_tiles`' copy) or raises; a CPU tensor takes
:func:`fast_winding_plain`, the JAX function's math in plain PyTorch. Both
read the same per-cluster table (:func:`cluster_table`: centroid, bounding
radius and dipole of each cluster, plain PyTorch over ``[K, M]``).
``launches`` counts kernel launches, so a run can show that the main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

MAX_NEAR = 16           # csrc/winding.cu's kMaxNear
MAX_CLUSTERS = 1024     # csrc/winding.cu's kMaxClusters

launches = 0            # kernel launches since the last reset

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["winding.cu"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.icon_fast_winding.argtypes = [vp, ci, vp, ci, vp, ci, ci, vp,
                                              vp]
            lib.icon_fast_winding.restype = ci
            pi = ctypes.POINTER(ci)
            lib.icon_winding_kernel_info.argtypes = [ci, pi, pi, pi, pi, pi]
            lib.icon_winding_kernel_info.restype = ci
            lib.icon_winding_error_string.argtypes = [ci]
            lib.icon_winding_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def cluster_table(verts: torch.Tensor, faces: torch.Tensor,
                  cluster_faces: torch.Tensor, cluster_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(table [K, 8] f32: centroid xyz, bounding radius, dipole xyz, 0;
    ctri [K, M, 9]: each slot's three corners; mask [K, M] bool) of the
    clusters (``icon_tpu/ops/sdf_fast.py:fast_winding``'s setup). The
    radius is the farthest corner from the centroid, so that clusters are
    ranked by their distance to a bounding sphere."""
    tri = verts[faces.long()]                             # [F, 3, 3]
    ctri = tri[cluster_faces.long()]                      # [K, M, 3, 3]
    mask = cluster_mask.bool()
    msk = mask[..., None].to(verts.dtype)
    e1 = ctri[:, :, 1] - ctri[:, :, 0]
    e2 = ctri[:, :, 2] - ctri[:, :, 0]
    an = 0.5 * torch.linalg.cross(e1, e2) * msk           # [K, M, 3]
    dip = an.sum(1)                                       # [K, 3]
    fc = ctri.mean(2) * msk
    cnt = torch.clamp(mask.sum(1, keepdim=True), min=1).to(verts.dtype)
    cent = fc.sum(1) / cnt                                # [K, 3]
    corner_d = torch.linalg.norm(ctri - cent[:, None, None], dim=-1)
    radius = (corner_d * msk).amax((1, 2))                # [K]
    table = torch.cat([cent, radius[:, None], dip,
                       torch.zeros_like(radius)[:, None]], dim=1)
    return table.contiguous(), ctri.reshape(*ctri.shape[:2], 9), mask


def face_tiles(ctri: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``ctri [K, M, 9]`` and ``mask [K, M]`` as the kernel reads them:
    ``[K, T, 10, 32]``, T = ceil(M / 32) tiles of 32 slots, a row for each
    of a slot's nine corner coordinates and a last row of its mask as 1 or
    0 (``[k, f // 32, c, f % 32] = ctri[k, f, c]``), zero past M. A warp's
    32 neighbouring slots of one row are one 128-byte line, and a slot's
    ten values lie a fixed stride apart."""
    K, M = mask.shape
    T = -(-M // 32)
    rows = torch.cat([ctri, mask[..., None].to(ctri.dtype)], dim=-1)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, 32 * T - M))
    return rows.reshape(K, T, 32, 10).transpose(2, 3).contiguous()


def _order_keys(gap: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering ``gap [c, K]`` ascending, ties to the lower
    cluster index (the float's order-preserving int32 image, then the
    index)."""
    bits = gap.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    k = torch.arange(gap.shape[1], device=gap.device)
    return bits.to(torch.int64) * (1 << 32) + k[None]


def fast_winding_plain(points: torch.Tensor, table: torch.Tensor,
                       ctri: torch.Tensor, mask: torch.Tensor, m: int,
                       chunk: int = 2048) -> torch.Tensor:
    """Winding numbers [N] of ``points [N, 3]`` from :func:`cluster_table`'s
    outputs: the dipole sum over every cluster plus, for the m clusters of
    smallest gap, their exact van Oosterom-Strackee solid angles over 2 pi
    minus their dipoles. Each term's products and sums are their own
    rounded float32 operations, in the order the kernel repeats; the terms
    are summed in float64 (their cancelling solid angles near the surface
    make float32 sums depend on the order by ~1e-5)."""
    K, M = mask.shape
    cx, cy, cz, rad, ax, ay, az, _ = table.unbind(1)
    fmask = mask.to(points.dtype)
    out = []
    for p in torch.split(points, chunk):
        px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        rx, ry, rz = cx[None] - px, cy[None] - py, cz[None] - pz   # [c, K]
        d2 = torch.clamp(rx * rx + ry * ry + rz * rz, min=1e-12)
        sq = torch.sqrt(d2)
        w_dip = (rx * ax[None] + ry * ay[None] + rz * az[None]) / \
            ((4.0 * math.pi) * d2 * sq)
        gap = sq - rad[None]
        idx = torch.topk(_order_keys(gap), m, dim=1, largest=False,
                         sorted=True).values & 0xFFFFFFFF         # [c, m]
        t = ctri[idx]                                         # [c, m, M, 9]
        pe = p[:, None, None]
        va = [t[..., j] - pe[..., j] for j in range(3)]
        vb = [t[..., 3 + j] - pe[..., j] for j in range(3)]
        vc = [t[..., 6 + j] - pe[..., j] for j in range(3)]

        def dot(u, v):
            return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

        la, lb, lc = (torch.sqrt(dot(u, u)) for u in (va, vb, vc))
        kr = (vb[1] * vc[2] - vb[2] * vc[1], vb[2] * vc[0] - vb[0] * vc[2],
              vb[0] * vc[1] - vb[1] * vc[0])
        num = dot(va, kr)
        den = la * lb * lc + dot(va, vb) * lc + dot(vb, vc) * la + \
            dot(vc, va) * lb
        omega = torch.atan2(num, den) * fmask[idx]            # [c, m, M]
        w_exact = omega.double().sum(-1) * (1.0 / (2.0 * math.pi))
        w_sel = torch.gather(w_dip, 1, idx).double()          # [c, m]
        out.append((w_dip.double().sum(-1) +
                    (w_exact - w_sel).sum(-1)).to(points.dtype))
    return torch.cat(out) if out else points.new_zeros((0,))


def _check(points, table, ctri, mask, m):
    if points.ndim != 2 or points.shape[-1] != 3:
        raise ValueError(f"points [N, 3] expected, got "
                         f"{tuple(points.shape)}")
    K, M = mask.shape
    if table.shape != (K, 8) or ctri.shape != (K, M, 9):
        raise ValueError(f"table [K, 8] and ctri [K, M, 9] expected for "
                         f"mask {tuple(mask.shape)}, got "
                         f"{tuple(table.shape)}, {tuple(ctri.shape)}")
    if not 1 <= m <= K:
        raise ValueError(f"m must be in [1, {K}], got {m}")
    for t in (table, ctri, mask):
        if t.device != points.device:
            raise ValueError(f"inputs on {t.device} and {points.device}")


def fast_winding_kernel(points: torch.Tensor, table: torch.Tensor,
                        ctri: torch.Tensor, mask: torch.Tensor, m: int,
                        chunk: int = 2048) -> torch.Tensor:
    """Winding numbers [N] f32 (inside ~ 1) of ``points [N, 3]``.

    CPU tensors take the plain version (``chunk`` points at a time). CUDA
    tensors must be float32 and contiguous (``mask`` bool), with K <= 1024
    and m <= 16; they launch the kernel on the current stream or raise."""
    global launches
    _check(points, table, ctri, mask, m)
    if points.device.type == "cpu":
        return fast_winding_plain(points, table, ctri, mask, m, chunk)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    for name, t in (("points", points), ("table", table), ("ctri", ctri)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise TypeError("mask must be a contiguous bool tensor")
    K, M = mask.shape
    if K > MAX_CLUSTERS or m > MAX_NEAR:
        raise ValueError(f"the kernel takes K <= {MAX_CLUSTERS} clusters and "
                         f"m <= {MAX_NEAR}, got K={K}, m={m}")
    if points.shape[0] >= 2 ** 31:
        raise ValueError(f"{points.shape[0]} points exceed int32 indexing")
    out = torch.empty((points.shape[0],), dtype=torch.float32,
                      device=points.device)
    _launch(points, table, face_tiles(ctri, mask), M, m, out)
    if points.shape[0]:
        launches += 1
    return out


def _launch(points, table, tiles, M, m, out) -> None:
    """One kernel launch into the caller-owned ``out`` [N] f32 (inputs
    checked by the caller, ``tiles`` = :func:`face_tiles` of M slots a
    cluster) on the current stream; counts nothing.
    :func:`fast_winding_kernel` and the kernel's timing use it."""
    lib = _load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icon_fast_winding(points.data_ptr(), points.shape[0],
                                    table.data_ptr(), table.shape[0],
                                    tiles.data_ptr(), M, m, out.data_ptr(),
                                    stream)
    _raise_on(lib, err, "icon_fast_winding launch")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.icon_winding_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def kernel_info(K: int) -> dict:
    """The kernel instance that K clusters launch on the current card:
    registers and local memory bytes a thread, threads a block, resident
    blocks an SM (the occupancy calculator's), SMs, and the resident warps'
    share of the SM's 64 (``occupancy``)."""
    lib = _load()
    vals = [ctypes.c_int(0) for _ in range(5)]
    _raise_on(lib, lib.icon_winding_kernel_info(K, *map(ctypes.byref, vals)),
              "icon_winding_kernel_info")
    regs, local_bytes, threads, per_sm, sms = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local_bytes,
            "threads": threads, "blocks_per_sm": per_sm, "sms": sms,
            "occupancy": per_sm * threads / 2048}
