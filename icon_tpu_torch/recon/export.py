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

from icon_tpu_torch.recon.marching import (AutoMarcher, fetch_mesh,
                                           marching_tetrahedra_indexed)


def make_marcher(max_cells: int = 1 << 18, max_tris: int = 1 << 20,
                 iso: float = 0.5) -> AutoMarcher:
    """A serving-loop marcher for :func:`extract_mesh`: the lattice codec
    (decoded on the card for a grid there, else wire v2 to the host),
    buffer autotuning across frames, the dropped-first-slice convention."""
    return AutoMarcher(max_cells=max_cells, max_tris=max_tris,
                       max_verts=min(2 * max_tris, 1 << 21), iso=iso,
                       slice_one=True, codec="lattice")


def extract_mesh(occ: torch.Tensor, iso: float = 0.5,
                 max_cells: int = 1 << 18, max_tris: int = 1 << 20,
                 marcher: Optional[AutoMarcher] = None,
                 coarse_occ: Optional[torch.Tensor] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3] float32, faces [F, 3] int64) from ``occ [R, R, R]``
    ([z, y, x]). Vertices are normalized to [-1, 1] by the full resolution
    R. With a ``marcher`` (:func:`make_marcher`, held across frames to keep
    its autotuned buffers) the mesh crosses on the lattice wire; without
    one it is the one-shot indexed mesh, as the JAX package exports it:
    :func:`marching_tetrahedra_indexed` and exact float32 vertices
    (:func:`fetch_mesh`). ``coarse_occ``, the engine's grid before its
    interpolation-only last level, limits the search to the cells of its
    mixed cells (the same mesh while its candidate buffer holds them)."""
    R = occ.shape[0]
    if marcher is not None:
        if not marcher.slice_one:
            raise ValueError("extract_mesh marchers drop slice 0 "
                             "(slice_one)")
        verts, faces = marcher.unpack(marcher.pack(
            marcher(occ, coarse_occ=coarse_occ)))
    else:
        out = marching_tetrahedra_indexed(
            occ[1:, 1:, 1:], iso, max_cells=max_cells, max_tris=max_tris,
            max_verts=min(2 * max_tris, 1 << 21), coarse_occ=coarse_occ)
        verts, faces = fetch_mesh(out)
    if len(verts):
        half = (R - 1) / 2.0
        # +1: sliced-grid index -> full-grid index (see module docstring)
        verts = (verts + 1.0 - half) / half
    return verts.astype(np.float32), np.asarray(faces, np.int64)
