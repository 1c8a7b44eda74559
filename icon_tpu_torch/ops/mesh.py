"""Mesh tensor utilities (``icon_tpu.ops.mesh``): vertex normals with
PyTorch3D ``verts_normals_padded`` semantics and the barycentric weights of
a point's projection onto its triangle's plane (Heidrich JGT'05, reference
lib/dataset/mesh_util.py:319-354)."""

from __future__ import annotations

import torch


def face_normals(verts: torch.Tensor, faces: torch.Tensor,
                 normalize: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Per-face normals ``[B, F, 3]`` of ``verts [B, V, 3]``,
    ``faces [F, 3]`` (right-hand rule over (v0, v1, v2))."""
    tris = verts[:, faces]                                # [B, F, 3, 3]
    n = torch.linalg.cross(tris[..., 1, :] - tris[..., 0, :],
                           tris[..., 2, :] - tris[..., 0, :], dim=-1)
    if normalize:
        n2 = torch.sum(n * n, dim=-1, keepdim=True)
        n = n / torch.sqrt(torch.clamp(n2, min=eps * eps))
    return n


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """Area-weighted unit vertex normals ``[B, V, 3]``: the un-normalized
    face cross products summed at each incident vertex, then normalized
    (zero stays zero)."""
    fn = face_normals(verts, faces, normalize=False)      # [B, F, 3]
    vn = torch.zeros_like(verts)
    for j in range(3):
        vn.index_add_(1, faces[:, j], fn)
    n2 = torch.sum(vn * vn, dim=-1, keepdim=True)
    return vn / torch.sqrt(torch.clamp(n2, min=eps * eps))


def barycentric_projection_weights(points: torch.Tensor,
                                   triangles: torch.Tensor,
                                   eps: float = 1e-6) -> torch.Tensor:
    """Barycentric weights ``[..., 3]`` of each point's projection onto its
    triangle's plane; they leave [0, 1] when the projection falls outside
    the triangle, as the reference's feature extrapolation expects.
    ``points [..., 3]``, ``triangles [..., 3, 3]``."""
    v0 = triangles[..., 0, :]
    u = triangles[..., 1, :] - v0
    v = triangles[..., 2, :] - v0
    n = torch.linalg.cross(u, v, dim=-1)
    s = torch.sum(n * n, dim=-1)
    s = torch.where(s == 0, torch.full_like(s, eps), s)
    w = points - v0
    b2 = torch.sum(torch.linalg.cross(u, w, dim=-1) * n, dim=-1) / s
    b1 = torch.sum(torch.linalg.cross(w, v, dim=-1) * n, dim=-1) / s
    return torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)
