"""Exact inside/outside labels on the host: clustered fast winding numbers
(a copy of ``icon_tpu.ops.winding_np``, which is pure numpy; the port keeps
its own so that it imports nothing of the JAX package, and
``tests/test_torch_signs.py`` pins it to the original).

The reference labels its training samples with embree ray casts
(lib/dataset/hoppeMesh.py:99-103 ``contains``), exact for watertight scans.
This is a numpy fast winding number in the spirit of Barill et al. 2018:

- faces cluster into a uniform grid over the mesh's bounding box;
- per cluster, the area-weighted normal (dipole) and centroid are
  precomputed;
- a query point evaluates the exact van Oosterom-Strackee solid angle for
  clusters closer than ``beta`` x the cluster radius and the dipole
  approximation  w ~ A.(c - p) / (4 pi |c - p|^3)  for the rest.
"""

from __future__ import annotations

import numpy as np


def solid_angles(points: np.ndarray, tris: np.ndarray,
                 chunk: int = 256) -> np.ndarray:
    """Summed signed solid angle / 4pi of ``tris [F, 3, 3]`` seen from
    ``points [N, 3]`` (van Oosterom & Strackee 1983). Returns [N].

    The JAX package's function on one ``[n, F]`` plane per coordinate
    instead of ``[n, F, 3]`` arrays, ``chunk`` points at a time or enough
    for 64k (point, face) pairs: the same float64 formula, several times
    faster in numpy."""
    N = len(points)
    chunk = max(chunk, 65536 // max(len(tris), 1))
    out = np.zeros(N, np.float64)
    t = [[np.ascontiguousarray(tris[None, :, j, k]) for k in range(3)]
         for j in range(3)]
    for s in range(0, N, chunk):
        p = points[s:s + chunk]
        a, b, c = ([t[j][k] - p[:, k:k + 1] for k in range(3)]
                   for j in range(3))
        la, lb, lc = (np.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
                      for x in (a, b, c))
        num = (a[0] * (b[1] * c[2] - b[2] * c[1])
               + a[1] * (b[2] * c[0] - b[0] * c[2])
               + a[2] * (b[0] * c[1] - b[1] * c[0]))
        den = (la * lb * lc
               + (a[0] * b[0] + a[1] * b[1] + a[2] * b[2]) * lc
               + (b[0] * c[0] + b[1] * c[1] + b[2] * c[2]) * la
               + (c[0] * a[0] + c[1] * a[1] + c[2] * a[2]) * lb)
        out[s:s + chunk] = np.arctan2(num, den).sum(-1) / (2.0 * np.pi)
    return out


class FastWinding:
    """Clustered winding-number evaluator for one mesh."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 grid: int = 8, beta: float = 2.0):
        self.tris = verts[faces].astype(np.float64)      # [F, 3, 3]
        cent = self.tris.mean(1)                         # [F, 3]
        e1 = self.tris[:, 1] - self.tris[:, 0]
        e2 = self.tris[:, 2] - self.tris[:, 0]
        an = 0.5 * np.cross(e1, e2)                      # area-weighted n
        self.beta = beta

        lo, hi = cent.min(0), cent.max(0)
        span = np.maximum(hi - lo, 1e-9)
        cell = np.minimum((cent - lo) / span * grid, grid - 1).astype(int)
        key = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
        order = np.argsort(key)
        key_s = key[order]
        starts = np.searchsorted(key_s, np.arange(grid ** 3))
        ends = np.searchsorted(key_s, np.arange(grid ** 3), side="right")

        self.clusters = []
        for k in range(grid ** 3):
            if starts[k] == ends[k]:
                continue
            fi = order[starts[k]:ends[k]]
            tri_k = self.tris[fi]
            c_k = cent[fi]
            # area-weighted centroid + conservative radius incl. the
            # farthest triangle corner
            area = np.linalg.norm(an[fi], axis=1)
            wsum = max(area.sum(), 1e-12)
            ctr = (c_k * area[:, None]).sum(0) / wsum
            rad = np.linalg.norm(tri_k.reshape(-1, 3) - ctr,
                                 axis=1).max()
            self.clusters.append({
                "faces": fi, "tris": tri_k, "center": ctr,
                "radius": rad, "dipole": an[fi].sum(0)})

    def winding(self, points: np.ndarray) -> np.ndarray:
        """[N, 3] -> generalized winding number [N] (inside ~ 1)."""
        pts = points.astype(np.float64)
        N = len(pts)
        w = np.zeros(N, np.float64)
        for cl in self.clusters:
            d = np.linalg.norm(pts - cl["center"], axis=1)
            near = d < self.beta * cl["radius"]
            if near.any():
                w[near] += solid_angles(pts[near], cl["tris"])
            far = ~near
            if far.any():
                rel = cl["center"] - pts[far]
                r3 = np.maximum(d[far] ** 3, 1e-12)
                w[far] += (rel @ cl["dipole"]) / (4.0 * np.pi * r3)
        return w

    def contains(self, points: np.ndarray) -> np.ndarray:
        return self.winding(points) > 0.5


def winding_inside(points: np.ndarray, verts: np.ndarray,
                   faces: np.ndarray) -> np.ndarray:
    """One-shot exact-near/dipole-far inside test."""
    return FastWinding(verts, faces).contains(points)
