"""Coarse grids whose mixed cells fall where ``lattice_cells``' wide tiles
are delicate, shared by ``tests/test_torch_lattice.py`` (the plain twin
against the JAX package) and ``tests/test_torch_lattice_cuda.py`` (the
kernel against the plain twin). Imports no JAX.

Each layout is ``(coarse [Dc, Hc, Wc] float32 numpy, max_candidates or
None)``; the fine grid is the coarse one's 2x align_corners upsample
sliced by one, as the engine's final level (:func:`fine_of`).
"""

import numpy as np
import torch

from icon_tpu_torch.kernels import lattice as kl
from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners


def fine_of(coarse: np.ndarray) -> np.ndarray:
    """The 2x align_corners upsample of ``coarse`` sliced by one."""
    c = torch.from_numpy(coarse)
    fine = resize3d_trilinear_align_corners(
        c[None, None], tuple(2 * s - 1 for s in c.shape))[0, 0]
    return fine[1:, 1:, 1:].contiguous().numpy()


def _blob(shape, seed: int) -> np.ndarray:
    """A lumpy ellipsoid filling most of ``shape``."""
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    rng = np.random.RandomState(seed)
    a, b, c = rng.uniform(3, 7, 3)
    r = np.sqrt((x / 0.8) ** 2 + (y / 0.7) ** 2 + (z / 0.75) ** 2)
    r = r + 0.1 * np.sin(a * x) * np.sin(b * y) * np.cos(c * z)
    return (1.0 / (1.0 + np.exp((r - 0.75) * 10))).astype(np.float32)


def mixed_in_first_tile(coarse: np.ndarray) -> int:
    """The mixed coarse cells of ``lattice_cells``' first tile."""
    mixed = kl._mixed_cells(torch.from_numpy(coarse), 0.5)
    iw = coarse.shape[2] - 1
    rows = mixed.reshape(-1, iw)       # [(z, y) rows, x]
    return int(rows[:kl.cells_tile_rows(iw)].sum())


def _tile_edge(shift: int):
    """A blob over 2 tiles of 64-cell rows, the candidate budget ending at
    the first tile's last mixed cell (``shift`` 0), one before it (-1) or
    at the second tile's first (+1)."""
    coarse = _blob((9, 17, 65), 1)
    m0 = mixed_in_first_tile(coarse)
    return coarse, 8 * (m0 + shift)


def _ragged():
    """Sides that are no multiple of a 32-cell word, nor of a tile's
    rows: 69 cells a row (3 words, 42 rows a tile), 220 rows."""
    return _blob((11, 23, 70), 2), None


def _faces():
    """Mixed cells on each of the 6 faces of the grid, corners and edges
    included, and none inside."""
    coarse = np.zeros((12, 14, 37), np.float32)
    D, H, W = coarse.shape
    for z, y, x in [(0, 5, 9), (D - 1, 7, 20), (6, 0, 30), (4, H - 1, 3),
                    (8, 9, 0), (3, 4, W - 1), (0, 0, 0),
                    (D - 1, H - 1, W - 1), (0, H - 1, W // 2)]:
        coarse[z, y, x] = 8.0
    return coarse, None


def _single(far: bool):
    """One mixed coarse cell, at the grid's first or last corner (a point
    of 8 there: its one fine cell inside the grid is alive)."""
    coarse = np.zeros((10, 12, 40), np.float32)
    coarse[(-1, -1, -1) if far else (0, 0, 0)] = 8.0
    return coarse, None


def _empty():
    return np.full((9, 11, 35), 0.25, np.float32), None


LAYOUTS = {
    "tile_edge_last": lambda: _tile_edge(0),
    "tile_edge_before": lambda: _tile_edge(-1),
    "tile_edge_next": lambda: _tile_edge(1),
    "ragged": _ragged,
    "ragged_budget": lambda: (_ragged()[0], 8 * 150),
    "faces": _faces,
    "single_first": lambda: _single(False),
    "single_last": lambda: _single(True),
    "empty": _empty,
}
