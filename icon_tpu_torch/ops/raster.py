"""Tile-based mesh rasterizer (``icon_tpu.ops.raster``), plain PyTorch.

The same two-level algorithm as the JAX package, so both give the same
images:

1. **Bin**: a dense ``[tiles, F]`` overlap matrix (conservative bounding
   box against tile) is compacted per tile into a static ``[tiles, K]``
   face list by a row-wise cumsum and one write into a buffer one slot
   longer per tile (the last slot takes the overflow, then is sliced off).
   Faces keep ascending order within a tile, which decides depth ties.
2. **Raster**: chunks of tiles evaluate the edge functions of every
   (pixel, face) pair of the tile, z-buffer by argmin depth (the first face
   wins a tie) and interpolate vertex attributes barycentrically; a soft
   silhouette aggregates per-face sigmoids in log space. The face counts
   are read to the host once per call: tiles without faces keep the
   background, the others run fullest first, and a chunk evaluates only as
   many of the K face slots as its fullest tile fills. The slots skipped
   are empty in every tile of the chunk, so no output changes, and a call
   costs tens of kernel launches instead of tens per 16 tiles.

Conventions: verts in NDC [-1, 1], x right, y DOWN (image row =
(y + 1) / 2 * H), smaller z is closer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RasterOut(NamedTuple):
    attr: torch.Tensor          # [H, W, C] interpolated attributes
    depth: torch.Tensor         # [H, W] z of the closest face (BIG if empty)
    mask: torch.Tensor          # [H, W] hard coverage (0/1 float)
    silhouette: torch.Tensor    # [H, W] soft coverage
    pix_to_face: torch.Tensor   # [H, W] int64, -1 where empty
    bin_overflow: torch.Tensor  # 0-d int64: (tile, face) pairs dropped


_BIG = 1e9


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


def rasterize(verts_ndc: torch.Tensor, faces: torch.Tensor,
              attrs: torch.Tensor, H: int = 512, W: int = 512,
              tile: int = 32, K: int = 256, sigma: float = 1e-4,
              tiles_per_step: int = 16) -> RasterOut:
    """Rasterize one mesh: ``verts_ndc [V, 3]``, ``faces [F, 3]`` (int64),
    ``attrs [V, C]`` to interpolate. ``sigma``: softness of the silhouette
    sigmoid in NDC^2 units (PyTorch3D's SoftSilhouetteShader default).
    ``tiles_per_step`` bounds the memory of one chunk to ``tiles_per_step
    * K`` (tile, face) slots, as in the JAX function; any value gives the
    same images. Returns a :class:`RasterOut` of ``[H, W, ...]`` images."""
    dev = verts_ndc.device
    xy_pix = (verts_ndc[:, :2] + 1.0) * 0.5 * torch.tensor(
        [W, H], dtype=verts_ndc.dtype, device=dev)
    z = verts_ndc[:, 2]
    tri_xy = xy_pix[faces]                                # [F, 3, 2]
    tri_z = z[faces]                                      # [F, 3]
    tri_attr = attrs[faces]                               # [F, 3, C]

    tiles_x = (W + tile - 1) // tile
    tiles_y = (H + tile - 1) // tile
    n_tiles = tiles_x * tiles_y
    face_list, counts, overflow = _bin_faces(tri_xy, tiles_x, tiles_y, tile,
                                             H, W, K)
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
        xy = tri_xy[tf]                                   # [nt, K, 3, 2]
        zz = tri_z[tf]                                    # [nt, K, 3]
        aa = tri_attr[tf]                                 # [nt, K, 3, C]

        ty = (tile_ids // tiles_x).to(torch.float32) * tile
        tx = (tile_ids % tiles_x).to(torch.float32) * tile
        pxx = px[None] + tx[:, None, None]                # [nt, tile, tile]
        pyy = py[None] + ty[:, None, None]
        p = torch.stack([pxx, pyy], -1).reshape(-1, n_pix, 1, 2)

        v0 = xy[:, None, :, 0]                            # [nt, 1, K, 2]
        v1 = xy[:, None, :, 1]
        v2 = xy[:, None, :, 2]

        def edge(a, b):
            return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) -
                    (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))

        e0 = edge(v1, v2)                                 # [nt, P, K]
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
            w2 * zz[:, None, :, 2]                        # [nt, P, K]
        zsel = torch.where(inside, zpix, torch.full_like(zpix, _BIG))
        best = torch.argmin(zsel, dim=2, keepdim=True)    # [nt, P, 1]
        bdepth = torch.gather(zsel, 2, best)[..., 0]
        bmask = (bdepth < _BIG).to(torch.float32)

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
        # saturated sigmoid
        log1mp = -torch.logaddexp(zs, torch.zeros_like(zs))
        log1mp = torch.where(torch.isfinite(zs), log1mp,
                             torch.zeros_like(log1mp))
        sil = -torch.expm1(torch.sum(log1mp, dim=2))
        return battr, bdepth, bmask, sil, bface

    # empty tiles keep the background; the others go fullest first in
    # chunks of at most tiles_per_step * K (tile, face) slots, and a chunk
    # runs only as many face slots as its fullest tile fills: the slots cut
    # off are -1 in every tile of the chunk, and a -1 slot never wins a
    # pixel nor adds to the silhouette
    images = (tri_attr.new_zeros((n_tiles, n_pix, tri_attr.shape[-1])),
              tri_z.new_full((n_tiles, n_pix), _BIG),
              tri_z.new_zeros((n_tiles, n_pix)),
              tri_z.new_zeros((n_tiles, n_pix)),
              face_list.new_full((n_tiles, n_pix), -1))
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

    battr, bdepth, bmask, sil, bface = map(untile, images)
    return RasterOut(attr=battr, depth=bdepth, mask=bmask, silhouette=sil,
                     pix_to_face=bface, bin_overflow=overflow)


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
