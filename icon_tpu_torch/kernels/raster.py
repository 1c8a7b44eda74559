"""The tile rasterizer's raster step: the CUDA kernels and their plain twin.

Given the binned face list ``[tiles, K]`` (``ops.raster._bin_faces``) and the
per-face data ``tri_xy [F, 3, 2]`` (pixel coordinates), ``tri_z [F, 3]`` and
``tri_attr [F, 3, C]``, every pixel of every tile evaluates the edge
functions of the tile's faces, keeps the first face with the smallest depth
among those it lies inside (a -1e-6 tolerance on the barycentrics), and
interpolates that face's attributes and depth; a soft silhouette aggregates
``1 - prod(1 - sigmoid(z))`` over every face of the tile in log space.
Gradients flow to ``tri_xy``, ``tri_z`` and ``tri_attr``.

:func:`raster` is the wrapper the rasterizer calls. A CUDA tensor runs
``csrc/raster.cu`` (``raster_fwd``, and ``raster_bwd`` in the backward of a
:class:`torch.autograd.Function`) or raises; a CPU tensor takes
:func:`raster_plain`, the same function in plain PyTorch, differentiable by
autograd. ``launches_fwd`` and ``launches_bwd`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import torch

BIG = 1e9
MAX_K = 2048
MAX_C = 16

launches_fwd = 0        # raster_fwd launches since the last reset
launches_bwd = 0        # raster_bwd launches since the last reset

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

Images = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor]


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["raster.cu"])
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            shape = [ci] * 7 + [cf, cf]
            lib.icon_raster_fwd_f32.argtypes = [vp] * 4 + shape + [vp] * 8
            lib.icon_raster_fwd_f32.restype = ci
            lib.icon_raster_bwd_f32.argtypes = [vp] * 4 + shape + [vp] * 9
            lib.icon_raster_bwd_f32.restype = ci
            lib.icon_raster_error_string.argtypes = [ci]
            lib.icon_raster_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def raster_plain(tri_xy: torch.Tensor, tri_z: torch.Tensor,
                 tri_attr: torch.Tensor, face_list: torch.Tensor,
                 counts: torch.Tensor, H: int, W: int, tile: int,
                 sigma: float, tiles_per_step: int) -> Images:
    """(attr [H, W, C], depth, mask, silhouette [H, W], pix_to_face [H, W]
    int64) in plain PyTorch: the JAX function's chunked tile raster.

    The face counts are read to the host once: tiles without faces keep the
    background, the others run fullest first in chunks of at most
    ``tiles_per_step * K`` (tile, face) slots, and a chunk evaluates only as
    many slots as its fullest tile fills (the slots cut off are -1 in every
    tile of the chunk, and a -1 slot never wins nor adds to the
    silhouette)."""
    dev = tri_xy.device
    n_tiles, K = face_list.shape
    tiles_x = (W + tile - 1) // tile
    tiles_y = (H + tile - 1) // tile
    counts = counts.tolist()          # one host read: the chunk widths

    # pixel centres within a tile
    off = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    py = off[:, None].expand(tile, tile)
    px = off[None, :].expand(tile, tile)
    n_pix = tile * tile

    def raster_tiles(tile_ids, k):                        # [nt], width
        t_faces = face_list[tile_ids, :k]                 # [nt, k]
        valid_f = t_faces >= 0
        tf = torch.clamp(t_faces, min=0)
        xy = tri_xy[tf]                                   # [nt, k, 3, 2]
        zz = tri_z[tf]                                    # [nt, k, 3]
        aa = tri_attr[tf]                                 # [nt, k, 3, C]

        ty = (tile_ids // tiles_x).to(torch.float32) * tile
        tx = (tile_ids % tiles_x).to(torch.float32) * tile
        pxx = px[None] + tx[:, None, None]                # [nt, tile, tile]
        pyy = py[None] + ty[:, None, None]
        p = torch.stack([pxx, pyy], -1).reshape(-1, n_pix, 1, 2)

        v0 = xy[:, None, :, 0]                            # [nt, 1, k, 2]
        v1 = xy[:, None, :, 1]
        v2 = xy[:, None, :, 2]

        def edge(a, b):
            return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) -
                    (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))

        e0 = edge(v1, v2)                                 # [nt, P, k]
        e1 = edge(v2, v0)
        e2 = edge(v0, v1)
        area = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) -
                (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
        area = torch.where(torch.abs(area) < 1e-9,
                           torch.full_like(area, 1e-9), area)

        w0 = e0 / area                                    # two-sided
        w1 = e1 / area
        w2 = e2 / area
        # -1e-6: on a shared edge float error can push both triangles'
        # tests slightly negative and open a crack; double coverage is
        # settled by the z-buffer instead
        inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6) & \
            valid_f[:, None, :]

        zpix = w0 * zz[:, None, :, 0] + w1 * zz[:, None, :, 1] + \
            w2 * zz[:, None, :, 2]                        # [nt, P, k]
        zsel = torch.where(inside, zpix, torch.full_like(zpix, BIG))
        best = torch.argmin(zsel, dim=2, keepdim=True)    # [nt, P, 1]
        bdepth = torch.gather(zsel, 2, best)[..., 0]
        bmask = (bdepth < BIG).to(torch.float32)

        def take(arr):
            return torch.gather(arr, 2, best)[..., 0]

        bf = torch.gather(tf[:, None, :].expand(-1, n_pix, -1), 2,
                          best)[..., 0]
        idx_c = best.expand(-1, -1, aa.shape[-1])         # [nt, P, C]
        battr = (take(w0)[..., None] * torch.gather(aa[:, :, 0], 1, idx_c) +
                 take(w1)[..., None] * torch.gather(aa[:, :, 1], 1, idx_c) +
                 take(w2)[..., None] * torch.gather(aa[:, :, 2], 1, idx_c))
        battr = battr * bmask[..., None]
        bface = torch.where(bmask > 0, bf, torch.full_like(bf, -1))

        # soft silhouette: signed 2D distance (normalized edge functions),
        # sigmoid-blended over faces (SoftRas aggregation)
        def elen(a, b):
            return torch.sqrt(torch.sum((b - a) ** 2, dim=-1) + 1e-12)

        scale = 0.5 * (W + H)                             # px -> ~ndc units
        d0 = e0 / elen(v1, v2)
        d1 = e1 / elen(v2, v0)
        d2 = e2 / elen(v0, v1)
        sgn = torch.sign(area)
        sdist = torch.minimum(torch.minimum(d0 * sgn, d1 * sgn), d2 * sgn) \
            / scale                                       # + inside
        zs = torch.sign(sdist) * sdist * sdist / sigma
        zs = torch.where(valid_f[:, None, :], zs,
                         torch.full_like(zs, float("-inf")))
        # 1 - prod(1 - sigmoid(z)) in log space: prod(1 - p) =
        # exp(-sum softplus(z)); a product of 1 - sigmoid loses every
        # saturated sigmoid, and its gradient divides by them
        log1mp = -torch.logaddexp(zs, torch.zeros_like(zs))
        log1mp = torch.where(torch.isfinite(zs), log1mp,
                             torch.zeros_like(log1mp))
        sil = -torch.expm1(torch.sum(log1mp, dim=2))
        return battr, bdepth, bmask, sil, bface

    images: List[torch.Tensor] = [
        tri_attr.new_zeros((n_tiles, n_pix, tri_attr.shape[-1])),
        tri_z.new_full((n_tiles, n_pix), BIG),
        tri_z.new_zeros((n_tiles, n_pix)),
        tri_z.new_zeros((n_tiles, n_pix)),
        face_list.new_full((n_tiles, n_pix), -1)]
    busy = sorted((i for i in range(n_tiles) if counts[i] > 0),
                  key=lambda i: -counts[i])
    start = 0
    while start < len(busy):
        k = counts[busy[start]]
        ids = busy[start:start + max(tiles_per_step * K // k, 1)]
        start += len(ids)
        ids = torch.tensor(ids, device=dev)
        for image, part in zip(images, raster_tiles(ids, k)):
            image[ids] = part

    def untile(x):
        # [n_tiles, tile*tile, ...] -> [H, W, ...]
        x = x.reshape(tiles_y, tiles_x, tile, tile, *x.shape[2:])
        x = x.transpose(1, 2).reshape(tiles_y * tile, tiles_x * tile,
                                      *x.shape[4:])
        return x[:H, :W]

    return tuple(map(untile, images))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.icon_raster_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


class _RasterKernel(torch.autograd.Function):
    """``raster_fwd`` forward, ``raster_bwd`` backward."""

    @staticmethod
    def forward(ctx, tri_xy, tri_z, tri_attr, face_list, H, W, tile, sigma):
        global launches_fwd
        lib = _load()
        n_tiles, K = face_list.shape
        C = tri_attr.shape[-1]
        tiles_x = (W + tile - 1) // tile
        scale = 0.5 * (W + H)
        dev = tri_xy.device
        attr = torch.empty((H, W, C), dtype=torch.float32, device=dev)
        depth, mask, sil, logsum = (
            torch.empty((H, W), dtype=torch.float32, device=dev)
            for _ in range(4))
        p2f = torch.empty((H, W), dtype=torch.int64, device=dev)
        win = torch.empty((H, W), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.icon_raster_fwd_f32(
                face_list.data_ptr(), tri_xy.data_ptr(), tri_z.data_ptr(),
                tri_attr.data_ptr(), n_tiles, K, C, H, W, tile, tiles_x,
                scale, sigma, attr.data_ptr(), depth.data_ptr(),
                mask.data_ptr(), sil.data_ptr(), p2f.data_ptr(),
                win.data_ptr(), logsum.data_ptr(), stream)
        _raise_on(lib, err, "raster_fwd")
        launches_fwd += 1
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(mask, p2f)
        ctx.save_for_backward(tri_xy, tri_z, tri_attr, face_list, win, logsum)
        ctx.shape = (H, W, tile, sigma)
        return attr, depth, mask, sil, p2f

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_attr, g_depth, _g_mask, g_sil, _g_p2f):
        global launches_bwd
        tri_xy, tri_z, tri_attr, face_list, win, logsum = ctx.saved_tensors
        H, W, tile, sigma = ctx.shape
        if g_attr is None and g_depth is None and g_sil is None:
            return (None,) * 8
        lib = _load()
        n_tiles, K = face_list.shape
        C = tri_attr.shape[-1]

        def grad_in(g):
            return None if g is None else g.to(torch.float32).contiguous()

        g_attr, g_depth, g_sil = map(grad_in, (g_attr, g_depth, g_sil))
        gxy, gz, ga = (torch.zeros_like(t) for t in (tri_xy, tri_z, tri_attr))
        with torch.cuda.device(tri_xy.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.icon_raster_bwd_f32(
                face_list.data_ptr(), tri_xy.data_ptr(), tri_z.data_ptr(),
                tri_attr.data_ptr(), n_tiles, K, C, H, W, tile,
                (W + tile - 1) // tile, 0.5 * (W + H), sigma, _ptr(g_attr),
                _ptr(g_depth), _ptr(g_sil), win.data_ptr(), logsum.data_ptr(),
                gxy.data_ptr(), gz.data_ptr(), ga.data_ptr(), stream)
        _raise_on(lib, err, "raster_bwd")
        launches_bwd += 1
        return gxy, gz, ga, None, None, None, None, None


def _check(tri_xy, tri_z, tri_attr, face_list) -> None:
    F = tri_xy.shape[0]
    if tri_xy.shape != (F, 3, 2) or tri_z.shape != (F, 3) or \
            tri_attr.ndim != 3 or tri_attr.shape[:2] != (F, 3) or \
            face_list.ndim != 2:
        raise ValueError(
            f"tri_xy [F, 3, 2], tri_z [F, 3], tri_attr [F, 3, C] and "
            f"face_list [tiles, K] expected, got {tuple(tri_xy.shape)}, "
            f"{tuple(tri_z.shape)}, {tuple(tri_attr.shape)}, "
            f"{tuple(face_list.shape)}")
    devs = {t.device for t in (tri_xy, tri_z, tri_attr, face_list)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def raster(tri_xy: torch.Tensor, tri_z: torch.Tensor, tri_attr: torch.Tensor,
           face_list: torch.Tensor, counts: torch.Tensor, H: int, W: int,
           tile: int = 32, sigma: float = 1e-4,
           tiles_per_step: int = 16) -> Images:
    """(attr [H, W, C], depth, mask, silhouette [H, W], pix_to_face [H, W]
    int64) of the binned faces; differentiable in ``tri_xy``, ``tri_z`` and
    ``tri_attr``.

    CPU tensors take :func:`raster_plain` (``counts`` and
    ``tiles_per_step`` set its chunks). CUDA tensors must be float32; they
    launch ``raster_fwd`` (and ``raster_bwd`` in the backward) on the
    current stream or raise, and read nothing to the host."""
    _check(tri_xy, tri_z, tri_attr, face_list)
    if tri_xy.device.type == "cpu":
        return raster_plain(tri_xy, tri_z, tri_attr, face_list, counts, H, W,
                            tile, sigma, tiles_per_step)
    if tri_xy.device.type != "cuda":
        raise ValueError(f"unsupported device {tri_xy.device}")
    for name, t in (("tri_xy", tri_xy), ("tri_z", tri_z),
                    ("tri_attr", tri_attr)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    n_tiles, K = face_list.shape
    C = tri_attr.shape[-1]
    if not 1 <= K <= MAX_K or not 1 <= C <= MAX_C or n_tiles > 65535 or \
            n_tiles != ((W + tile - 1) // tile) * ((H + tile - 1) // tile):
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}, 1 <= C <= "
                         f"{MAX_C} and one list per tile; got K={K}, C={C}, "
                         f"{n_tiles} lists for {H}x{W} in {tile}-px tiles")
    if tri_xy.shape[0] >= 2 ** 31 // 6:
        raise ValueError(f"{tri_xy.shape[0]} faces exceed int32 indexing")
    return _RasterKernel.apply(
        tri_xy.contiguous(), tri_z.contiguous(), tri_attr.contiguous(),
        face_list.to(torch.int32).contiguous(), H, W, tile, float(sigma))
