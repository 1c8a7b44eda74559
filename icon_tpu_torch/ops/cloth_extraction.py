"""Garment extraction from 2D segmentation polygons (a numpy copy of
``icon_tpu.ops.cloth_extraction``; reference
lib/common/cloth_extraction.py:45-170).

Given a clothing segmentation (polygons in 512^2 image space, the JSON the
demo's ``-seg_dir`` holds), keep the reconstruction's faces whose vertices
all project inside the garment's polygons, then the largest connected
component. :func:`smpl_to_recon_labels` transfers SMPL part labels to the
reconstruction by nearest SMPL vertex.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def point_in_polygon(px: np.ndarray, py: np.ndarray,
                     poly: np.ndarray) -> np.ndarray:
    """Even-odd rule for ``[N]`` points against one ``[M, 2]`` polygon."""
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(px.shape, bool)
    for xa, ya, xb, yb in zip(x0, y0, x1, y1):
        cond = ((ya > py) != (yb > py))
        denom = np.where(yb == ya, 1e-12, yb - ya)
        xint = xa + (py - ya) * (xb - xa) / denom
        inside ^= cond & (px < xint)
    return inside


def project_to_pixels(verts: np.ndarray, image_size: int = 512
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Render-space verts (y up, [-1, 1]) -> pixel coordinates (row down),
    the rasterizer's mapping (``render/camera.py:verts_to_ndc``)."""
    px = (verts[:, 0] + 1.0) * 0.5 * image_size
    py = (-verts[:, 1] + 1.0) * 0.5 * image_size
    return px, py


def largest_component(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Indices of the faces in the largest vertex-connected component."""
    parent = np.arange(n_verts)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        r0 = find(f[0])
        for v in f[1:]:
            rv = find(v)
            if rv != r0:
                parent[rv] = r0
    roots = np.array([find(f[0]) for f in faces])
    vals, counts = np.unique(roots, return_counts=True)
    return np.where(roots == vals[np.argmax(counts)])[0]


def extract_cloth(verts: np.ndarray, faces: np.ndarray, seg: Dict,
                  image_size: int = 512
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One garment's (verts, faces) cut from the reconstruction, or None
    when its polygons select nothing (cloth_extraction.py:75)."""
    coords = seg.get("coordinates") or seg.get("coord")
    if coords is None:
        return None
    px, py = project_to_pixels(np.asarray(verts), image_size)
    inside = np.zeros(len(verts), bool)
    for poly in coords:
        poly = np.asarray(poly, np.float32).reshape(-1, 2)
        if len(poly) >= 3:
            inside |= point_in_polygon(px, py, poly)
    if not inside.any():
        return None

    keep = inside[faces].all(axis=1)
    kept_faces = faces[keep]
    if len(kept_faces) == 0:
        return None
    comp = largest_component(kept_faces, len(verts))
    kept_faces = kept_faces[comp]

    used = np.unique(kept_faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return np.asarray(verts)[used], remap[kept_faces]


def smpl_to_recon_labels(recon_verts: np.ndarray, smpl_verts: np.ndarray,
                         part_segmentation: Dict[str, List[int]],
                         k: int = 1) -> Dict[str, np.ndarray]:
    """SMPL part labels on the reconstruction's vertices, by nearest SMPL
    vertex (cloth_extraction.py:45-73); ``part_segmentation`` maps each
    part to its vertex ids (``smpl_vert_segmentation.json``)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(np.asarray(smpl_verts))
    _, nn = tree.query(np.asarray(recon_verts), k=k)
    nn = nn.reshape(len(recon_verts), -1)[:, 0]
    vert_part = np.full(len(smpl_verts), -1, np.int64)
    names = sorted(part_segmentation)
    for pi, pname in enumerate(names):
        vert_part[np.asarray(part_segmentation[pname], np.int64)] = pi
    labels = vert_part[nn]
    return {name: np.where(labels == pi)[0]
            for pi, name in enumerate(names)}
