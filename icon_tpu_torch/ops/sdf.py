"""Exact point -> mesh signed distance and closest-surface features
(``icon_tpu.ops.sdf``; reference ``cal_sdf_batch``,
lib/dataset/mesh_util.py:357-396).

A brute-force sweep of every point against every face, chunked on both axes
as the JAX function is (``point_chunk`` points by ``chunk`` faces at a
time): the exact point-triangle distance (the plane projection when it
falls inside, else the nearest of the three edges), the index of the
closest face (the first one on a tie), and the generalized winding number
(van Oosterom-Strackee solid angles) that signs it. Faces are padded to a
whole chunk with degenerate triangles far away, which cannot win the
minimum and add no solid angle.

This is the oracle: ``HGPIFuNet.query`` falls back to it without a
vertex-face table, and the evaluator measures its distances with it. The
serving and training paths use the candidate-face features of
``ops/sdf_fast.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from icon_tpu_torch.ops.mesh import (barycentric_projection_weights,
                                     vertex_normals)

_FAR = 1e8          # padding triangles live here


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _tri_dist_sq(px, py, pz, t):
    """Squared point-triangle distance; ``t`` is 9 planes (v0x .. v2z)."""
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = t
    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    vx, vy, vz = v2x - v0x, v2y - v0y, v2z - v0z
    nx, ny, nz = _cross3(ux, uy, uz, vx, vy, vz)
    n2 = _dot3(nx, ny, nz, nx, ny, nz)
    degenerate = n2 <= 1e-12
    wx, wy, wz = px - v0x, py - v0y, pz - v0z

    s = torch.where(degenerate, torch.full_like(n2, 1e-6), n2)
    cx, cy, cz = _cross3(ux, uy, uz, wx, wy, wz)
    b2 = _dot3(cx, cy, cz, nx, ny, nz) / s
    cx, cy, cz = _cross3(wx, wy, wz, vx, vy, vz)
    b1 = _dot3(cx, cy, cz, nx, ny, nz) / s
    b0 = 1.0 - b1 - b2
    inside = (b0 >= 0) & (b0 <= 1) & (b1 >= 0) & (b1 <= 1) & \
        (b2 >= 0) & (b2 <= 1)

    pn = _dot3(wx, wy, wz, nx, ny, nz)
    d_plane = torch.where(inside & ~degenerate,
                          pn * pn / torch.clamp(n2, min=1e-12),
                          torch.full_like(pn, math.inf))

    def seg(ax_, ay_, az_, bx_, by_, bz_):
        ex, ey, ez = bx_ - ax_, by_ - ay_, bz_ - az_
        sx, sy, sz = px - ax_, py - ay_, pz - az_
        tt = torch.clamp(_dot3(sx, sy, sz, ex, ey, ez) /
                         torch.clamp(_dot3(ex, ey, ez, ex, ey, ez),
                                     min=1e-12), 0.0, 1.0)
        dx, dy, dz = sx - tt * ex, sy - tt * ey, sz - tt * ez
        return _dot3(dx, dy, dz, dx, dy, dz)

    d = torch.minimum(d_plane, seg(v0x, v0y, v0z, v1x, v1y, v1z))
    d = torch.minimum(d, seg(v1x, v1y, v1z, v2x, v2y, v2z))
    return torch.minimum(d, seg(v2x, v2y, v2z, v0x, v0y, v0z))


def _solid_angle(px, py, pz, t):
    """van Oosterom-Strackee signed solid angle of each triangle."""
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = t
    ax, ay, az = v0x - px, v0y - py, v0z - pz
    bx, by, bz = v1x - px, v1y - py, v1z - pz
    cx, cy, cz = v2x - px, v2y - py, v2z - pz
    la = torch.sqrt(_dot3(ax, ay, az, ax, ay, az))
    lb = torch.sqrt(_dot3(bx, by, bz, bx, by, bz))
    lc = torch.sqrt(_dot3(cx, cy, cz, cx, cy, cz))
    kx, ky, kz = _cross3(bx, by, bz, cx, cy, cz)
    det = _dot3(ax, ay, az, kx, ky, kz)
    den = (la * lb * lc + _dot3(ax, ay, az, bx, by, bz) * lc +
           _dot3(bx, by, bz, cx, cy, cz) * la +
           _dot3(cx, cy, cz, ax, ay, az) * lb)
    return 2.0 * torch.atan2(det, den)


def point_mesh_dist_winding(points: torch.Tensor, triangles: torch.Tensor,
                            chunk: int = 1024, point_chunk: int = 8192
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """For ``points [N, 3]`` against ``triangles [F, 3, 3]``: (squared
    distance [N], closest face [N] int64, winding number [N])."""
    N, F = points.shape[0], triangles.shape[0]
    pad = (-F) % chunk
    if pad:
        triangles = torch.cat([triangles, triangles.new_full(
            (pad, 3, 3), _FAR)])
    planes = triangles.reshape(-1, chunk, 9)              # [nc, chunk, 9]
    d2_out, idx_out, wind_out = [], [], []
    for s in range(0, N, point_chunk):
        p = points[s:s + point_chunk]
        px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        best = p.new_full((p.shape[0],), math.inf)
        best_idx = torch.zeros((p.shape[0],), dtype=torch.int64,
                               device=p.device)
        wind = p.new_zeros((p.shape[0],))
        for c in range(planes.shape[0]):
            t = tuple(planes[c, None, :, j] for j in range(9))
            d2 = _tri_dist_sq(px, py, pz, t)              # [pc, chunk]
            wind = wind + _solid_angle(px, py, pz, t).sum(1)
            cmin, cidx = torch.min(d2, dim=1)
            better = cmin < best
            best = torch.where(better, cmin, best)
            best_idx = torch.where(better, cidx + c * chunk, best_idx)
        d2_out.append(best)
        idx_out.append(best_idx)
        wind_out.append(wind)
    return (torch.cat(d2_out), torch.clamp(torch.cat(idx_out), 0, F - 1),
            torch.cat(wind_out) / (4.0 * math.pi))


def cal_sdf_batch(verts: torch.Tensor, faces: torch.Tensor,
                  cmaps: torch.Tensor, vis: torch.Tensor,
                  points: torch.Tensor, chunk: int = 1024):
    """ICON's body-local features by the exact sweep: ``verts [B, V, 3]``,
    ``faces [F, 3]`` (shared), ``cmaps [B, V, 3]``, ``vis [B, V, 1]``,
    ``points [B, N, 3]`` -> (sdf [B,N,1] positive inside, normal [B,N,3]
    with the reference's (-1, 1, -1) flip, cmap [B,N,3], vis [B,N,1]
    thresholded at 0.1), interpolated on the closest face at the
    unclamped barycentrics of the point's projection."""
    faces = faces.long()
    normals = vertex_normals(verts, faces)
    outs = []
    for b in range(points.shape[0]):
        tris = verts[b][faces]                            # [F, 3, 3]
        d2, idx, wind = point_mesh_dist_winding(points[b], tris, chunk)
        fv = faces[idx]                                   # [N, 3]
        w = barycentric_projection_weights(points[b], tris[idx])[..., None]
        flip = torch.tensor([-1.0, 1.0, -1.0], dtype=verts.dtype,
                            device=verts.device)
        nrm = torch.sum(normals[b][fv] * w, dim=-2) * flip
        cmap = torch.sum(cmaps[b][fv] * w, dim=-2)
        vq = (torch.sum(vis[b][fv] * w, dim=-2) >= 0.1).to(verts.dtype)
        dist = torch.sqrt(d2) / math.sqrt(3.0)
        sdf = torch.where(torch.abs(wind) > 0.5, dist, -dist)[..., None]
        outs.append((sdf, nrm, cmap, vq))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))


def check_inside(verts: torch.Tensor, faces: torch.Tensor,
                 points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Winding-number inside test (kaolin ``check_sign``): bool
    ``[B, N]``."""
    faces = faces.long()
    return torch.stack([
        torch.abs(point_mesh_dist_winding(points[b], verts[b][faces],
                                          chunk)[2]) > 0.5
        for b in range(points.shape[0])])
