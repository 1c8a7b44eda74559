"""Mesh renders over the tile rasterizer (``icon_tpu.render.render``;
reference lib/common/render.py:60-387): body normal images, soft
silhouettes, depth, vertex colours, and per-vertex colour from the input
image."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.ops.grid_sample import grid_sample_2d
from icon_tpu_torch.ops.mesh import vertex_normals
from icon_tpu_torch.ops.raster import rasterize, vertex_visibility
from icon_tpu_torch.render.camera import verts_to_ndc, view_matrix


def normal_raster(verts: torch.Tensor, faces: torch.Tensor, size: int = 512,
                  azimuth: float = 0.0, K: int = 256):
    """The :class:`~icon_tpu_torch.ops.raster.RasterOut` whose attributes
    are the vertex normals in the view frame (x right, y up, z toward the
    viewer)."""
    vn = vertex_normals(verts[None], faces)[0]
    R = device_constant(view_matrix(azimuth), verts.dtype, verts.device)
    return rasterize(verts_to_ndc(verts, azimuth), faces, vn @ R.T,
                     H=size, W=size, K=K)


def render_normal(verts: torch.Tensor, faces: torch.Tensor, size: int = 512,
                  azimuth: float = 0.0, K: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal image in [-1, 1] (reference get_rgb_image with the normal
    shader): (normal ``[H, W, 3]``, mask ``[H, W]``)."""
    out = normal_raster(verts, faces, size, azimuth, K)
    return out.attr, out.mask


def render_normal_sil(verts: torch.Tensor, faces: torch.Tensor,
                      size: int = 512, azimuth: float = 0.0, K: int = 256):
    """The SMPL fit's two targets from one raster: (normal ``[H, W, 3]``,
    mask ``[H, W]``, soft silhouette ``[H, W]``)."""
    out = normal_raster(verts, faces, size, azimuth, K)
    return out.attr, out.mask, out.silhouette


def _plain_raster(verts, faces, size, azimuth, K):
    return rasterize(verts_to_ndc(verts, azimuth), faces,
                     verts.new_zeros((verts.shape[0], 1)), H=size, W=size,
                     K=K)


def render_silhouette(verts: torch.Tensor, faces: torch.Tensor,
                      size: int = 512, azimuth: float = 0.0,
                      K: int = 256) -> torch.Tensor:
    """Soft silhouette ``[H, W]`` (reference get_silhouette_image)."""
    return _plain_raster(verts, faces, size, azimuth, K).silhouette


def render_depth(verts: torch.Tensor, faces: torch.Tensor, size: int = 512,
                 azimuth: float = 0.0, K: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth ``[H, W]``, mask ``[H, W]``)."""
    out = _plain_raster(verts, faces, size, azimuth, K)
    return out.depth, out.mask


def render_color(verts: torch.Tensor, faces: torch.Tensor,
                 colors: torch.Tensor, size: int = 512, azimuth: float = 0.0,
                 K: int = 256, bg: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertex-coloured render on a grey background: (rgb ``[H, W, 3]`` in
    [0, 1], mask ``[H, W]``)."""
    out = rasterize(verts_to_ndc(verts, azimuth), faces, colors, H=size,
                    W=size, K=K)
    m = out.mask[..., None]
    return out.attr * m + bg * (1.0 - m), out.mask


def make_turntable_renderer(faces: torch.Tensor, colors: torch.Tensor,
                            size: int = 512, K: int = 256, bg: float = 0.5):
    """The turntable's frame renderer: faces and vertex colours stay on
    their device, each frame's azimuth enters as pre-rotated vertices
    ``[V, 3]`` (render space, y up), flipped to NDC by ``(1, -1, -1)``;
    returns ``render(v_rot) -> rgb [size, size, 3]``, the colours over a
    grey background, forward only."""
    flip = torch.tensor([1.0, -1.0, -1.0], device=colors.device)

    @torch.no_grad()
    def render(v_rot: torch.Tensor) -> torch.Tensor:
        out = rasterize(v_rot * flip, faces, colors, H=size, W=size, K=K)
        m = out.mask[..., None]
        return out.attr * m + bg * (1.0 - m)

    return render


def query_color(verts: torch.Tensor, faces: torch.Tensor,
                image: torch.Tensor,
                visibility: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-vertex RGB ``[V, 3]`` in [0, 1] from ``image [H, W, 3]`` in
    [-1, 1] (reference query_color, render.py:60-84): visible vertices
    sample the image bilinearly, the others get (normal + 1) / 2.
    ``visibility [V, 1]`` is rasterized when not given."""
    ndc = verts_to_ndc(verts)
    if visibility is None:
        visibility = vertex_visibility(ndc, faces)
    rgb = (grid_sample_2d(image[None], ndc[None, :, :2])[0] + 1.0) * 0.5
    fallback = (vertex_normals(verts[None], faces)[0] + 1.0) * 0.5
    return torch.where(visibility > 0.5, rgb, fallback)
