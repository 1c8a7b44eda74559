"""Offline training-data renders (``icon_tpu.data.render_dataset``;
reference scripts/render_single.py), on the port's rasterizer.

Per subject and view azimuth :func:`render_subject_views` writes the layout
``PIFuDataset`` reads (docs/dataset.md)::

    {root}/{dataset}_{R}views/{subject}/
        calib/{y:03d}.txt                  extrinsic (4x4) over intrinsic
        render/{y:03d}.png                 SH-lit RGBA render of the scan
        normal_F|normal_B/{y:03d}.png      scan normals (view frame)
        T_normal_F|T_normal_B/{y:03d}.png  SMPL body normals
        vis/{y:03d}.npy                    per-SMPL-vertex visibility

View y turns the mesh about the world y axis under an orthographic camera;
the back images are inverse-depth renders (the farthest surface wins), so
they are pixel-aligned with the front ones; ``render`` lights the scan's
normals by a random order-2 spherical-harmonics environment per view. The
rasterizer and the vertex visibility run on the device of the caller's
choice: on the card they are the raster kernels. With a ``prt`` transport
(:func:`compute_prt`: self-shadowed PRT, one depth raster a light
direction) the render lights the scan by its per-vertex irradiance
instead, interpolated by the same raster as the normals.

:func:`make_calib`, :func:`sh_basis`, :func:`random_sh` and
:func:`fibonacci_sphere` are copies of the JAX module's.
"""

from __future__ import annotations

import math
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np
import torch


def make_calib(azimuth_deg: float, scale: float = 1.0) -> np.ndarray:
    """8x4 calib file contents: extrinsic (4x4) over intrinsic (4x4).

    ``intrinsic @ extrinsic`` maps world vertices (y up, the [-1, 1] box) to
    the rasterizer's NDC frame: x right, y down, smaller z closer (the same
    [1, -1, -1] flip as ``render.camera.verts_to_ndc``)."""
    a = math.radians(azimuth_deg)
    c, s = math.cos(a), math.sin(a)
    extrinsic = np.array([[c, 0, -s, 0],
                          [0, 1, 0, 0],
                          [s, 0, c, 0],
                          [0, 0, 0, 1]], np.float32)
    intrinsic = np.diag([scale, -scale, -scale, 1.0]).astype(np.float32)
    return np.concatenate([extrinsic, intrinsic], axis=0)


# order-2 SH basis (9 coeffs) — prt_util.py's analytic irradiance terms
_SH_C = np.array([0.282095, 0.488603, 0.488603, 0.488603, 1.092548,
                  1.092548, 0.315392, 1.092548, 0.546274], np.float32)


def sh_basis(n: np.ndarray) -> np.ndarray:
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return np.stack([
        np.ones_like(x) * _SH_C[0],
        _SH_C[1] * y, _SH_C[2] * z, _SH_C[3] * x,
        _SH_C[4] * x * y, _SH_C[5] * y * z,
        _SH_C[6] * (3 * z * z - 1), _SH_C[7] * x * z,
        _SH_C[8] * (x * x - y * y)], axis=-1)


def random_sh(rng: np.random.RandomState) -> np.ndarray:
    """A plausible random environment: ambient + dominant directional."""
    sh = np.zeros((9, 3), np.float32)
    sh[0] = 2.4 + 0.8 * rng.rand(3)
    d = rng.randn(3)
    d /= np.linalg.norm(d)
    sh[1:4] = (0.3 + 0.4 * rng.rand()) * np.array(
        [d[1], d[2], d[0]], np.float32)[:, None]
    sh[4:] = 0.1 * (rng.rand(5, 3) - 0.5)
    return sh


def fibonacci_sphere(n: int) -> np.ndarray:
    """[n, 3] near-uniform unit directions."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], -1).astype(np.float32)


def compute_prt(verts: np.ndarray, faces: np.ndarray, n_dirs: int = 64,
                vis_res: int = 512, device="cuda") -> np.ndarray:
    """Per-vertex diffuse PRT transport ``[V, 9]`` with self-shadowing
    (reference prt_util.py computePRT): ``T_lm = (4 / K) sum_k vis_k
    cos+ Y_lm(d_k)`` over ``n_dirs`` Fibonacci directions, ``vis_k`` by
    :func:`~icon_tpu_torch.ops.raster.vertex_visibility_depth` from each
    direction (K depth rasters instead of V * K rays).

    The directions' frames, the vertex normals' cosines and the float32
    sum of ``T`` stay host numpy, in the JAX function's order; the vertex
    normals, the rasters and the visibility run on ``device``."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    from icon_tpu_torch.ops.raster import vertex_visibility_depth

    dev = torch.device(device)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    v = torch.as_tensor(np.asarray(verts), dtype=torch.float32, device=dev)
    vn = vertex_normals(v[None], f)[0].cpu().numpy()
    dirs = fibonacci_sphere(n_dirs)
    T = np.zeros((len(verts), 9), np.float32)
    flip = np.array([1, -1, -1], np.float32)
    for d in dirs:
        # orthonormal frame with +z = d; the rasterizer looks along -z
        z = d
        up = np.array([0.0, 1.0, 0.0], np.float32)
        if abs(np.dot(up, z)) > 0.95:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z]).astype(np.float32)      # world -> view
        ndc = (verts @ R.T) * flip
        vis = vertex_visibility_depth(
            torch.as_tensor(ndc, dtype=torch.float32, device=dev), f,
            res=vis_res).cpu().numpy()
        cos = np.maximum(vn @ d, 0.0)
        T += (vis * cos)[:, None] * sh_basis(d)[None]
    return T * (4.0 / n_dirs)


def _save_png(path: str, rgb01: np.ndarray, mask01: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(osp.dirname(path), exist_ok=True)
    rgba = np.concatenate([np.clip(rgb01, 0, 1),
                           np.clip(mask01[..., None], 0, 1)], axis=-1)
    Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(path)


def render_subject_views(out_dir: str,
                         scan_verts: np.ndarray, scan_faces: np.ndarray,
                         smpl_verts: Optional[np.ndarray],
                         smpl_faces: Optional[np.ndarray],
                         rotations: Sequence[int], size: int = 512,
                         seed: int = 0, with_light: bool = True,
                         prt: Optional[np.ndarray] = None,
                         vis_res: Optional[int] = None,
                         device="cuda") -> None:
    """Render every view of one subject into ``out_dir`` (its
    ``{dataset}_{R}views/{subject}`` folder). Vertices are in world units
    that the calib maps into [-1, 1]. ``prt``: the scan's ``[V, 9]``
    transport from :func:`compute_prt`; the renders are then ``0.75 *``
    its irradiance under the view's light (concavities darken), carried
    through the normals' raster as three more attribute channels.
    ``vis_res`` is the SMPL visibility's raster size (the reference's
    4096^2 by default, mesh_util.py:295)."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    from icon_tpu_torch.ops.raster import rasterize, vertex_visibility
    from icon_tpu_torch.render.camera import view_matrix

    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    sv = torch.as_tensor(np.asarray(scan_verts, np.float32), device=dev)
    sf = torch.as_tensor(np.asarray(scan_faces), dtype=torch.int64,
                         device=dev)
    s_vn = vertex_normals(sv[None], sf)[0]
    if smpl_verts is not None:
        bv = torch.as_tensor(np.asarray(smpl_verts, np.float32), device=dev)
        bf = torch.as_tensor(np.asarray(smpl_faces), dtype=torch.int64,
                             device=dev)
        b_vn = vertex_normals(bv[None], bf)[0]
    flip = torch.tensor([1.0, -1.0, -1.0], device=dev)

    def views(ndc, faces, attr):
        """Front and back renders of ``attr``; yields (suffix, attr image,
        mask) as numpy."""
        for suffix, zsign in (("F", 1.0), ("B", -1.0)):
            z = torch.tensor([1.0, 1.0, zsign], device=dev)
            out = rasterize(ndc * z, faces, attr, H=size, W=size)
            yield suffix, out.attr.cpu().numpy(), out.mask.cpu().numpy()

    for y in rotations:
        calib8 = make_calib(y)
        cpath = osp.join(out_dir, "calib", f"{y:03d}.txt")
        os.makedirs(osp.dirname(cpath), exist_ok=True)
        np.savetxt(cpath, calib8)
        R = torch.as_tensor(view_matrix(y), device=dev)

        # view frame for normals: x right, y up, z toward the viewer;
        # images store (n + 1) / 2
        sh = random_sh(rng) if with_light else None
        s_attr = s_vn @ R.T
        lit = prt is not None and sh is not None
        if lit:                    # the view's PRT irradiance, per vertex
            irr = torch.as_tensor(np.clip(prt @ sh, 0, None),
                                  dtype=torch.float32, device=dev)
            s_attr = torch.cat([s_attr, irr], dim=-1)
        for suffix, attr, mask in views((sv @ R.T) * flip, sf, s_attr):
            nimg = attr[..., :3]
            _save_png(osp.join(out_dir, f"normal_{suffix}", f"{y:03d}.png"),
                      (nimg + 1) * 0.5, mask)
            if suffix == "F":
                albedo = np.full((size, size, 3), 0.75, np.float32)
                if lit:
                    rgb = np.clip(albedo * attr[..., 3:6], 0, 1)
                elif sh is not None:
                    rgb = np.clip(albedo * (sh_basis(nimg) @ sh), 0, 1)
                else:
                    rgb = (nimg + 1) * 0.5
                _save_png(osp.join(out_dir, "render", f"{y:03d}.png"),
                          rgb, mask)

        if smpl_verts is not None:
            b_ndc = (bv @ R.T) * flip
            for suffix, nimg, mask in views(b_ndc, bf, b_vn @ R.T):
                _save_png(osp.join(out_dir, f"T_normal_{suffix}",
                                   f"{y:03d}.png"), (nimg + 1) * 0.5, mask)
            # per-view SMPL visibility (reference vis_single.py:42-64)
            vis = vertex_visibility(b_ndc, bf, res=vis_res or 4096)
            vpath = osp.join(out_dir, "vis", f"{y:03d}.npy")
            os.makedirs(osp.dirname(vpath), exist_ok=True)
            np.save(vpath, vis.cpu().numpy().astype(np.float32))
