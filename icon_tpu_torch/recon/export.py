"""Occupancy grid -> mesh, following the reference export conventions
(``icon_tpu.recon.export``; seg3d_lossless.py:583-604 + apps/ICON.py:446-450):
drop the first slice along each axis, march at iso 0.5 in (x, y, z) vertex
order, normalize vertices to [-1, 1] by (R-1)/2.

As in the JAX package, the dropped first slice is added back (+1) before
normalizing, so meshes sit on the true level set instead of one voxel below,
left of and behind it as the reference's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from icon_tpu_torch.recon.marching import AutoMarcher


def make_marcher(max_cells: int = 1 << 18, max_tris: int = 1 << 20,
                 iso: float = 0.5) -> AutoMarcher:
    """A serving-loop marcher for :func:`extract_mesh`: lattice wire v2,
    buffer autotuning across frames, the dropped-first-slice convention."""
    return AutoMarcher(max_cells=max_cells, max_tris=max_tris,
                       max_verts=min(2 * max_tris, 1 << 21), iso=iso,
                       slice_one=True)


def extract_mesh(occ: torch.Tensor, iso: float = 0.5,
                 max_cells: int = 1 << 18, max_tris: int = 1 << 20,
                 marcher: Optional[AutoMarcher] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3] float32, faces [F, 3] int64) from ``occ [R, R, R]``
    ([z, y, x]). Vertices are normalized to [-1, 1] by the full resolution
    R. Without a ``marcher`` a one-shot :func:`make_marcher` is
    used; hold one across frames to keep its autotuned buffers."""
    R = occ.shape[0]
    if marcher is None:
        marcher = make_marcher(max_cells, max_tris, iso)
    if not marcher.slice_one:
        raise ValueError("extract_mesh marchers drop slice 0 (slice_one)")
    verts, faces = marcher.unpack(marcher.pack(marcher(occ)))
    if len(verts):
        half = (R - 1) / 2.0
        # +1: sliced-grid index -> full-grid index (see module docstring)
        verts = (verts + 1.0 - half) / half
    return verts.astype(np.float32), np.asarray(faces, np.int64)
