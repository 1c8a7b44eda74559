"""The tile rasterizer: the CUDA kernels and their plain twins.

The rasterizer (``ops.raster.rasterize``) bins each face into the 32x32
tiles its bounding box touches, keeping each tile's first ``K`` faces in
ascending face id (``[tiles, K]``, -1 padded; the pairs past K are counted
as ``bin_overflow``), then every pixel of every tile evaluates the edge
functions of the tile's faces, keeps the first face with the smallest depth
among those it lies inside (a -1e-6 tolerance on the barycentrics), and
interpolates that face's attributes and depth; a soft silhouette aggregates
``1 - prod(1 - sigmoid(z))`` over every face of the tile in log space.
Gradients flow to the vertices and their attributes.

:func:`rasterize` is the wrapper the rasterizer calls. A CUDA tensor runs
``csrc/raster.cu``: ``raster_setup`` (per-face slot data and tile boxes),
``raster_bin`` (the ``[tiles, K]`` lists), ``raster_fwd``, and
``raster_bwd`` in the backward of a :class:`torch.autograd.Function`,
three launches forward and no host read; or it raises. A CPU tensor takes
:func:`rasterize_plain`: :func:`bin_faces_plain` and :func:`raster_plain`,
the same function in plain PyTorch, differentiable by autograd.
:func:`bin_faces` is the binning alone (setup and bin on the card). The
``launches_*`` counters count kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import torch

BIG = 1e9
MAX_K = 2048
MAX_C = 16
TILE = 32               # the kernels' tile side
SLOT_FIELDS = 6         # float4 per face of slot data (csrc/raster.cu)
CHUNK = 256             # faces per chunk box
TARGET_BLOCKS = 4096    # raster_fwd blocks to aim for: tiles x splits

launches_setup = 0      # raster_setup launches since the last reset
launches_bin = 0        # raster_bin launches since the last reset
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
            lib.icon_raster_setup.argtypes = [vp, vp] + [ci] * 3 + [vp] * 6
            lib.icon_raster_setup.restype = ci
            lib.icon_raster_bin.argtypes = [vp, vp] + [ci] * 4 + [vp] * 4
            lib.icon_raster_bin.restype = ci
            shape = [vp, vp, vp, ci, vp, vp] + [ci] * 6 + [cf]
            lib.icon_raster_fwd.argtypes = shape + [vp] * 12
            lib.icon_raster_fwd.restype = ci
            lib.icon_raster_bwd.argtypes = shape + [vp] * 8
            lib.icon_raster_bwd.restype = ci
            lib.icon_raster_error_string.argtypes = [ci]
            lib.icon_raster_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def pixel_xy(verts_ndc: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Pixel coordinates ``[V, 2]`` of NDC vertices (x right, y down)."""
    return (verts_ndc[:, :2] + 1.0) * 0.5 * torch.tensor(
        [W, H], dtype=verts_ndc.dtype, device=verts_ndc.device)


def _bin_faces(xy: torch.Tensor, tiles_x: int, tiles_y: int, tile: int,
               H: int, W: int, K: int):
    """Conservative face -> tile binning of ``xy [F, 3, 2]`` pixel coords
    in plain PyTorch (the binning kernel's plain version): (face list
    ``[tiles, K]``, -1 padded, ascending; faces per tile, at most K;
    overflow count). A dense ``[tiles, F]`` overlap matrix is compacted
    per tile by a row-wise cumsum and one write into a buffer one slot
    longer per tile (the last slot takes the overflow, then is sliced
    off)."""
    n_faces = xy.shape[0]
    dev = xy.device
    fx_min = torch.amin(xy[..., 0], dim=1)
    fx_max = torch.amax(xy[..., 0], dim=1)
    fy_min = torch.amin(xy[..., 1], dim=1)
    fy_max = torch.amax(xy[..., 1], dim=1)

    def tile_of(c, n):
        return torch.clamp(torch.floor(c / tile), 0, n - 1).to(torch.int64)

    tx0, tx1 = tile_of(fx_min, tiles_x), tile_of(fx_max, tiles_x)
    ty0, ty1 = tile_of(fy_min, tiles_y), tile_of(fy_max, tiles_y)
    offscreen = (fx_max < 0) | (fx_min > W) | (fy_max < 0) | (fy_min > H)

    n_tiles = tiles_y * tiles_x
    t = torch.arange(n_tiles, device=dev)[:, None]
    ty, tx = t // tiles_x, t % tiles_x
    overlap = ((tx >= tx0[None]) & (tx <= tx1[None]) &
               (ty >= ty0[None]) & (ty <= ty1[None]) &
               ~offscreen[None])                          # [T, F]

    pos = torch.cumsum(overlap, dim=1) - 1                # [T, F]
    take = overlap & (pos < K)
    flat_to = torch.where(take, pos, K) + t * (K + 1)
    face_ids = torch.arange(n_faces, device=dev).expand(n_tiles, n_faces)
    buf = torch.full((n_tiles * (K + 1),), -1, dtype=torch.int64, device=dev)
    buf[flat_to.reshape(-1)] = face_ids.reshape(-1)
    face_list = buf.view(n_tiles, K + 1)[:, :K]
    counts = pos[:, -1] + 1
    overflow = torch.sum(torch.clamp(counts - K, min=0))
    return face_list, torch.clamp(counts, max=K), overflow


def _tiles(H: int, W: int, tile: int) -> Tuple[int, int]:
    return (W + tile - 1) // tile, (H + tile - 1) // tile


def bin_faces_plain(verts_ndc: torch.Tensor, faces: torch.Tensor, H: int,
                    W: int, tile: int = TILE, K: int = 256):
    """(face list ``[tiles, K]`` int64, counts ``[tiles]``, overflow) of
    ``verts_ndc [V, 3]`` and ``faces [F, 3]`` in plain PyTorch."""
    tiles_x, tiles_y = _tiles(H, W, tile)
    xy = pixel_xy(verts_ndc.detach(), H, W)[faces]
    return _bin_faces(xy, tiles_x, tiles_y, tile, H, W, K)


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


def rasterize_plain(verts_ndc: torch.Tensor, faces: torch.Tensor,
                    attrs: torch.Tensor, H: int, W: int, tile: int = TILE,
                    K: int = 256, sigma: float = 1e-4,
                    tiles_per_step: int = 16):
    """(attr, depth, mask, silhouette, pix_to_face, bin_overflow) in plain
    PyTorch on any device, differentiable by autograd: the per-face
    gathers, :func:`_bin_faces` and :func:`raster_plain`."""
    tri_xy = pixel_xy(verts_ndc, H, W)[faces]             # [F, 3, 2]
    tri_z = verts_ndc[:, 2][faces]                        # [F, 3]
    tri_attr = attrs[faces]                               # [F, 3, C]
    tiles_x, tiles_y = _tiles(H, W, tile)
    face_list, counts, overflow = _bin_faces(tri_xy.detach(), tiles_x,
                                             tiles_y, tile, H, W, K)
    images = raster_plain(tri_xy, tri_z, tri_attr, face_list, counts, H, W,
                          tile, sigma, tiles_per_step)
    return (*images, overflow)


def splits(n_tiles: int, K: int) -> Tuple[int, int]:
    """(S, R): ``raster_fwd``/``raster_bwd`` run S blocks per tile, each
    over R of its slots (a multiple of 16, at most 512; S at most 8 unless
    K needs more), so that about ``TARGET_BLOCKS`` blocks share the busy
    tiles' work."""
    S = max(1, min(-(-K // 16), -(-TARGET_BLOCKS // n_tiles), 8),
            -(-K // 512))
    R = -(-(-(-K // S)) // 16) * 16
    return -(-K // R), R


def _sil_constant(H: int, W: int, sigma: float) -> float:
    """1 / (scale^2 sigma), scale = (W + H) / 2: z = m |m| times this."""
    scale = 0.5 * (W + H)
    return 1.0 / (scale * scale * sigma)


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.icon_raster_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _bin_kernel(verts_ndc, faces, H, W, K):
    """``raster_setup`` and ``raster_bin`` on the current stream: (slot data
    ``[6, F, 4]``, face list ``[tiles, K]`` int32, counts ``[tiles]`` int32,
    overflow 0-d int64, per-tile counters ``[tiles]`` int32)."""
    global launches_setup, launches_bin
    lib = _load()
    dev = verts_ndc.device
    F = faces.shape[0]
    tiles_x, tiles_y = _tiles(H, W, TILE)
    n_tiles = tiles_x * tiles_y

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    slot = empty((SLOT_FIELDS, F, 4), torch.float32)
    box = empty((F, 4), torch.int32)
    chunk_box = empty((-(-F // CHUNK), 4), torch.int32)
    tile_done = empty((n_tiles,), torch.int32)
    overflow = empty((), torch.int64)
    face_list = empty((n_tiles, K), torch.int32)
    counts = empty((n_tiles,), torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icon_raster_setup(
            verts_ndc.data_ptr(), faces.data_ptr(), F, H, W, slot.data_ptr(),
            box.data_ptr(), chunk_box.data_ptr(), tile_done.data_ptr(),
            overflow.data_ptr(), stream)
        _raise_on(lib, err, "raster_setup")
        launches_setup += 1
        err = lib.icon_raster_bin(
            box.data_ptr(), chunk_box.data_ptr(), F, H, W, K,
            face_list.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
            stream)
    _raise_on(lib, err, "raster_bin")
    launches_bin += 1
    return slot, face_list, counts, overflow, tile_done


class _RasterKernel(torch.autograd.Function):
    """``raster_setup``, ``raster_bin`` and ``raster_fwd`` forward,
    ``raster_bwd`` backward (into ``[V, 3]`` and ``[V, C]``)."""

    @staticmethod
    def forward(ctx, verts_ndc, attrs, faces, H, W, K, sigma):
        global launches_fwd
        slot, face_list, counts, overflow, tile_done = _bin_kernel(
            verts_ndc, faces, H, W, K)
        lib = _load()
        dev = verts_ndc.device
        C = attrs.shape[-1]
        tiles_x, tiles_y = _tiles(H, W, TILE)
        n_tiles = tiles_x * tiles_y
        S, R = splits(n_tiles, K)
        kz = _sil_constant(H, W, sigma)

        def empty(shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=dev)

        attr = empty((H, W, C))
        depth, mask, sil, logsum = (empty((H, W)) for _ in range(4))
        p2f = empty((H, W), torch.int64)
        win = empty((H, W), torch.int32)
        part = (None, None, None)
        if S > 1:
            n = n_tiles * S * TILE * TILE
            part = (empty((n,)), empty((n,), torch.int32), empty((n,)))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.icon_raster_fwd(
                face_list.data_ptr(), counts.data_ptr(), slot.data_ptr(),
                faces.shape[0], faces.data_ptr(), attrs.data_ptr(), K, R, S,
                C, H, W, kz, *map(_ptr, part), tile_done.data_ptr(),
                attr.data_ptr(), depth.data_ptr(), mask.data_ptr(),
                sil.data_ptr(), p2f.data_ptr(), win.data_ptr(),
                logsum.data_ptr(), stream)
        _raise_on(lib, err, "raster_fwd")
        launches_fwd += 1
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(mask, p2f, overflow)
        ctx.save_for_backward(faces, attrs, slot, face_list, counts, win,
                              logsum)
        ctx.shape = (verts_ndc.shape[0], H, W, K, S, R, kz)
        return attr, depth, mask, sil, p2f, overflow

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_attr, g_depth, _g_mask, g_sil, _g_p2f, _g_over):
        global launches_bwd
        faces, attrs, slot, face_list, counts, win, logsum = \
            ctx.saved_tensors
        V, H, W, K, S, R, kz = ctx.shape
        if g_attr is None and g_depth is None and g_sil is None:
            return (None,) * 7
        lib = _load()
        C = attrs.shape[-1]

        def grad_in(g):
            return None if g is None else g.to(torch.float32).contiguous()

        g_attr, g_depth, g_sil = map(grad_in, (g_attr, g_depth, g_sil))
        g_verts = attrs.new_zeros((V, 3))
        g_attrs = torch.zeros_like(attrs)
        with torch.cuda.device(attrs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.icon_raster_bwd(
                face_list.data_ptr(), counts.data_ptr(), slot.data_ptr(),
                faces.shape[0], faces.data_ptr(), attrs.data_ptr(), K, R, S,
                C, H, W, kz, _ptr(g_attr), _ptr(g_depth), _ptr(g_sil),
                win.data_ptr(), logsum.data_ptr(), g_verts.data_ptr(),
                g_attrs.data_ptr(), stream)
        _raise_on(lib, err, "raster_bwd")
        launches_bwd += 1
        return g_verts, g_attrs, None, None, None, None, None


def _check(verts_ndc, faces, attrs, H, W, tile, K) -> None:
    if verts_ndc.ndim != 2 or verts_ndc.shape[1] != 3 or faces.ndim != 2 \
            or faces.shape[1] != 3 or attrs.ndim != 2 or \
            attrs.shape[0] != verts_ndc.shape[0]:
        raise ValueError(
            f"verts_ndc [V, 3], faces [F, 3] and attrs [V, C] expected, got "
            f"{tuple(verts_ndc.shape)}, {tuple(faces.shape)}, "
            f"{tuple(attrs.shape)}")
    devs = {t.device for t in (verts_ndc, faces, attrs)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_kernel(verts_ndc, faces, attrs, H, W, tile, K) -> None:
    """What the kernels take: float32 vertices and attributes, 32-px
    tiles, 1 <= K <= MAX_K, 1 <= C <= MAX_C, at most 65,535 tiles."""
    if verts_ndc.device.type != "cuda":
        raise ValueError(f"unsupported device {verts_ndc.device}")
    for name, t in (("verts_ndc", verts_ndc), ("attrs", attrs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tiles_x, tiles_y = _tiles(H, W, tile)
    C = attrs.shape[1]
    if tile != TILE or not 1 <= K <= MAX_K or not 1 <= C <= MAX_C or \
            tiles_x * tiles_y > 65535:
        raise ValueError(f"the kernels take {TILE}-px tiles, 1 <= K <= "
                         f"{MAX_K}, 1 <= C <= {MAX_C} and at most 65,535 "
                         f"tiles; got tile={tile}, K={K}, C={C}, {H}x{W}")
    if faces.shape[0] >= 2 ** 31 // CHUNK:
        raise ValueError(f"{faces.shape[0]} faces exceed int32 indexing")


def bin_faces(verts_ndc: torch.Tensor, faces: torch.Tensor, H: int, W: int,
              tile: int = TILE, K: int = 256):
    """(face list ``[tiles, K]``, counts ``[tiles]``, overflow): each tile's
    first K overlapping faces in ascending id, -1 padded, the faces per
    tile clamped to K, and the (tile, face) pairs dropped. CPU tensors take
    :func:`bin_faces_plain` (int64 lists); CUDA tensors launch
    ``raster_setup`` and ``raster_bin`` (int32 lists) or raise."""
    attrs = verts_ndc[:, :1]
    _check(verts_ndc, faces, attrs, H, W, tile, K)
    if verts_ndc.device.type == "cpu":
        return bin_faces_plain(verts_ndc, faces, H, W, tile, K)
    _check_kernel(verts_ndc, faces, attrs, H, W, tile, K)
    _, face_list, counts, overflow, _ = _bin_kernel(
        verts_ndc.detach().contiguous(), faces.to(torch.int64).contiguous(),
        H, W, K)
    return face_list, counts, overflow


def rasterize(verts_ndc: torch.Tensor, faces: torch.Tensor,
              attrs: torch.Tensor, H: int, W: int, tile: int = TILE,
              K: int = 256, sigma: float = 1e-4, tiles_per_step: int = 16):
    """(attr [H, W, C], depth, mask, silhouette [H, W], pix_to_face [H, W]
    int64, bin_overflow 0-d int64) of ``faces [F, 3]`` over ``verts_ndc
    [V, 3]`` with per-vertex ``attrs [V, C]``; differentiable in
    ``verts_ndc`` and ``attrs``.

    CPU tensors take :func:`rasterize_plain` (``tiles_per_step`` sets its
    chunks). CUDA tensors must be float32; they launch ``raster_setup``,
    ``raster_bin`` and ``raster_fwd`` (and ``raster_bwd`` in the backward)
    on the current stream or raise, and read nothing to the host."""
    _check(verts_ndc, faces, attrs, H, W, tile, K)
    if verts_ndc.device.type == "cpu":
        return rasterize_plain(verts_ndc, faces, attrs, H, W, tile, K, sigma,
                               tiles_per_step)
    _check_kernel(verts_ndc, faces, attrs, H, W, tile, K)
    return _RasterKernel.apply(verts_ndc.contiguous(), attrs.contiguous(),
                               faces.to(torch.int64).contiguous(), H, W, K,
                               float(sigma))
