"""Differentiable tile-based mesh rasterizer (``icon_tpu.ops.raster``).

The same two-level algorithm as the JAX package, so both give the same
images:

1. **Bin**: each face's conservative bounding box marks the 32x32 tiles it
   may cover; each tile lists its first ``K`` such faces in ascending face
   id (``[tiles, K]``, -1 padded), which decides depth ties; the pairs past
   K are dropped and counted in ``bin_overflow``.
2. **Raster**: every pixel of a tile evaluates the edge functions of the
   tile's faces, z-buffers by argmin depth (the first face wins a tie) and
   interpolates vertex attributes barycentrically; a soft silhouette
   aggregates per-face sigmoids in log space.

Both steps live in ``icon_tpu_torch/kernels/raster.py``: on the card the
hand-written CUDA kernels (``raster_setup``, ``raster_bin``, ``raster_fwd``
and ``raster_bwd``, no host read and no ``[tiles, F]`` tensor); on the CPU
the plain version (a dense ``[tiles, F]`` overlap matrix compacted by a
cumsum; the raster reads the face counts to the host once per call to size
its chunks).

Gradients reach ``verts_ndc`` and ``attrs`` through the winning face's
barycentrics, the depth and the silhouette, as in the JAX function.

On the raster: :func:`vertex_visibility` (face-id visibility, the
reference's) and :func:`vertex_visibility_depth` (point visibility by a
PCF depth compare, the PRT's).

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


def rasterize(verts_ndc: torch.Tensor, faces: torch.Tensor,
              attrs: torch.Tensor, H: int = 512, W: int = 512,
              tile: int = 32, K: int = 256, sigma: float = 1e-4,
              tiles_per_step: int = 16) -> RasterOut:
    """Rasterize one mesh: ``verts_ndc [V, 3]``, ``faces [F, 3]`` (int64),
    ``attrs [V, C]`` to interpolate. ``sigma``: softness of the silhouette
    sigmoid in NDC^2 units (PyTorch3D's SoftSilhouetteShader default).
    Differentiable in ``verts_ndc`` and ``attrs`` (through the winning
    face's barycentrics, the depth and the soft silhouette).

    On a CUDA tensor this is the hand-written kernel chain
    (``kernels/raster.py``: three launches, no host read); on a CPU tensor
    it is the plain version, whose chunks ``tiles_per_step`` bounds to
    ``tiles_per_step * K`` (tile, face) slots, as in the JAX function (any
    value gives the same images). Returns a :class:`RasterOut` of
    ``[H, W, ...]`` images."""
    return RasterOut(*raster_kernel.rasterize(
        verts_ndc, faces, attrs, H, W, tile, K, sigma, tiles_per_step))


def rasterize_plain(verts_ndc: torch.Tensor, faces: torch.Tensor,
                    attrs: torch.Tensor, H: int = 512, W: int = 512,
                    tile: int = 32, K: int = 256, sigma: float = 1e-4,
                    tiles_per_step: int = 16) -> RasterOut:
    """:func:`rasterize` in plain PyTorch on any device (the kernels'
    reference on the card)."""
    return RasterOut(*raster_kernel.rasterize_plain(
        verts_ndc, faces, attrs, H, W, tile, K, sigma, tiles_per_step))


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


def vertex_visibility_depth(verts_ndc: torch.Tensor, faces: torch.Tensor,
                            res: int = 512,
                            eps_px: float = 1.0) -> torch.Tensor:
    """Per-vertex *point* visibility ``[V]`` in [0, 1] by a shadow-map
    depth compare (the PRT transport's visibility; reference prt_util.py
    casts a ray per vertex).

    One ``res``^2 depth raster (K=512); each vertex, offset by ``1e-3 *
    ext`` along its vertex normal (``ext`` the smallest extent of the
    vertices; prt_util.py's ray-origin ``delta``), passes a texel when its
    depth is at most the texel's plus ``eps_px`` pixels (``2 / res`` NDC
    each); the four texels around its pixel-centre position, clipped to
    the image, blend bilinearly. Empty texels hold BIG, so they pass."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    n_verts = verts_ndc.shape[0]
    out = rasterize(verts_ndc, faces, verts_ndc.new_zeros((n_verts, 1)),
                    H=res, W=res, K=512)
    vn = vertex_normals(verts_ndc[None], faces)[0]
    ext = torch.min(verts_ndc.amax(0) - verts_ndc.amin(0))
    q = verts_ndc + (1e-3 * ext) * vn
    xy = (q[:, :2] + 1.0) * 0.5 * res - 0.5            # pixel-centre coords
    zq = q[:, 2]
    x0 = torch.floor(xy[:, 0]).to(torch.int64)
    y0 = torch.floor(xy[:, 1]).to(torch.int64)
    fx = xy[:, 0] - x0
    fy = xy[:, 1] - y0
    eps = eps_px * (2.0 / res)                 # ~a pixel of surface slope
    vis = verts_ndc.new_zeros((n_verts,))
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi = torch.clamp(x0 + dx, 0, res - 1)
            yi = torch.clamp(y0 + dy, 0, res - 1)
            d = out.depth[yi, xi]
            vis = vis + (wx * wy) * (zq <= d + eps)
    return vis
