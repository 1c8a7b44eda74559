"""Differentiable tile-based mesh rasterizer (``icon_tpu.ops.raster``).

The same two-level algorithm as the JAX package, so both give the same
images:

1. **Bin** (PyTorch on every device): a dense ``[tiles, F]`` overlap
   matrix (conservative bounding box against tile) is compacted per tile
   into a static ``[tiles, K]`` face list by a row-wise cumsum and one
   write into a buffer one slot longer per tile (the last slot takes the
   overflow, then is sliced off). Faces keep ascending order within a
   tile, which decides depth ties.
2. **Raster** (``icon_tpu_torch/kernels/raster.py``): every pixel of a
   tile evaluates the edge functions of the tile's faces, z-buffers by
   argmin depth (the first face wins a tie) and interpolates vertex
   attributes barycentrically; a soft silhouette aggregates per-face
   sigmoids in log space. On the card this is the hand-written CUDA pair
   ``raster_fwd``/``raster_bwd``; on the CPU the plain version, which
   reads the face counts to the host once per call to size its chunks.

Gradients reach ``verts_ndc`` and ``attrs`` through the winning face's
barycentrics, the depth and the silhouette, as in the JAX function.

Conventions: verts in NDC [-1, 1], x right, y DOWN (image row =
(y + 1) / 2 * H), smaller z is closer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icon_tpu_torch.kernels import raster as raster_kernel


class RasterOut(NamedTuple):
    attr: torch.Tensor          # [H, W, C] interpolated attributes
    depth: torch.Tensor         # [H, W] z of the closest face (BIG if empty)
    mask: torch.Tensor          # [H, W] hard coverage (0/1 float)
    silhouette: torch.Tensor    # [H, W] soft coverage
    pix_to_face: torch.Tensor   # [H, W] int64, -1 where empty
    bin_overflow: torch.Tensor  # 0-d int64: (tile, face) pairs dropped


def _bin_faces(xy: torch.Tensor, tiles_x: int, tiles_y: int, tile: int,
               H: int, W: int, K: int):
    """Conservative face -> tile binning of ``xy [F, 3, 2]`` pixel coords:
    (face list ``[tiles, K]``, -1 padded, ascending; faces per tile, at
    most K; overflow count)."""
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


def _prepare(verts_ndc, faces, attrs, H, W, tile, K):
    """Per-face pixel coords, depths and attributes, and the binned face
    list of ``verts_ndc [V, 3]`` (x, y in [-1, 1])."""
    xy_pix = (verts_ndc[:, :2] + 1.0) * 0.5 * torch.tensor(
        [W, H], dtype=verts_ndc.dtype, device=verts_ndc.device)
    tri_xy = xy_pix[faces]                                # [F, 3, 2]
    tri_z = verts_ndc[:, 2][faces]                        # [F, 3]
    tri_attr = attrs[faces]                               # [F, 3, C]
    tiles_x = (W + tile - 1) // tile
    tiles_y = (H + tile - 1) // tile
    face_list, counts, overflow = _bin_faces(tri_xy.detach(), tiles_x,
                                             tiles_y, tile, H, W, K)
    return tri_xy, tri_z, tri_attr, face_list, counts, overflow


def rasterize(verts_ndc: torch.Tensor, faces: torch.Tensor,
              attrs: torch.Tensor, H: int = 512, W: int = 512,
              tile: int = 32, K: int = 256, sigma: float = 1e-4,
              tiles_per_step: int = 16) -> RasterOut:
    """Rasterize one mesh: ``verts_ndc [V, 3]``, ``faces [F, 3]`` (int64),
    ``attrs [V, C]`` to interpolate. ``sigma``: softness of the silhouette
    sigmoid in NDC^2 units (PyTorch3D's SoftSilhouetteShader default).
    Differentiable in ``verts_ndc`` and ``attrs`` (through the winning
    face's barycentrics, the depth and the soft silhouette).

    On a CUDA tensor the raster step is the hand-written kernel pair
    (``kernels/raster.py``, no host read); on a CPU tensor it is the plain
    version, whose chunks ``tiles_per_step`` bounds to ``tiles_per_step
    * K`` (tile, face) slots, as in the JAX function (any value gives the
    same images). Returns a :class:`RasterOut` of ``[H, W, ...]`` images."""
    tri_xy, tri_z, tri_attr, face_list, counts, overflow = _prepare(
        verts_ndc, faces, attrs, H, W, tile, K)
    images = raster_kernel.raster(tri_xy, tri_z, tri_attr, face_list, counts,
                                  H, W, tile, sigma, tiles_per_step)
    return RasterOut(*images, bin_overflow=overflow)


def rasterize_plain(verts_ndc: torch.Tensor, faces: torch.Tensor,
                    attrs: torch.Tensor, H: int = 512, W: int = 512,
                    tile: int = 32, K: int = 256, sigma: float = 1e-4,
                    tiles_per_step: int = 16) -> RasterOut:
    """:func:`rasterize` with the plain raster step on any device (the
    kernel's reference on the card)."""
    tri_xy, tri_z, tri_attr, face_list, counts, overflow = _prepare(
        verts_ndc, faces, attrs, H, W, tile, K)
    images = raster_kernel.raster_plain(tri_xy, tri_z, tri_attr, face_list,
                                        counts, H, W, tile, sigma,
                                        tiles_per_step)
    return RasterOut(*images, bin_overflow=overflow)


def vertex_visibility(verts_ndc: torch.Tensor, faces: torch.Tensor,
                      res: int = 1024) -> torch.Tensor:
    """Per-vertex visibility ``[V, 1]`` with the reference's face-id
    semantics (mesh_util.py:280-316): a vertex is visible when one of its
    faces is front-most at some pixel of a ``res``^2 raster."""
    n_verts = verts_ndc.shape[0]
    out = rasterize(verts_ndc, faces, verts_ndc.new_zeros((n_verts, 1)),
                    H=res, W=res, K=512)
    pf = out.pix_to_face.reshape(-1)
    fv = faces[torch.clamp(pf, min=0)]                    # [P, 3]
    fv = torch.where(pf[:, None] >= 0, fv, torch.full_like(fv, n_verts))
    vis = verts_ndc.new_zeros((n_verts + 1,))
    vis[fv.reshape(-1)] = 1.0                             # slot V: empty px
    return vis[:n_verts, None]
