"""Isotropic remeshing and smoothing (``icon_tpu.ops.remesh``, copied whole:
host numpy, pinned identical to the JAX package's by a test). It stands for
the reference's pymeshlab ``remesh``/``possion`` host ops
(lib/dataset/mesh_util.py:109-133), called between the implicit
reconstruction and the cloth refinement (apps/infer.py:402) so that the
LocalAffine deformation works on near-uniform triangles: the
Botsch-Kobbelt loop of long-edge split, short-edge collapse,
valence-improving flips and tangential relaxation, then a Taubin smooth.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mesh_edges_np(faces: np.ndarray) -> np.ndarray:
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    e.sort(axis=1)
    return np.unique(e, axis=0)


def vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (``icon_tpu.data.datasets``'s host
    helper)."""
    tri = verts[faces]                                  # [F, 3, 3]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    for j in range(3):
        np.add.at(vn, faces[:, j], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def split_long_edges(verts: np.ndarray, faces: np.ndarray,
                     max_len: float) -> Tuple[np.ndarray, np.ndarray]:
    """One pass of 1-to-4 / 1-to-2 subdivision of triangles with edges longer
    than ``max_len`` (midpoints shared across faces)."""
    verts = list(map(tuple, verts))
    vout = [np.asarray(v, np.float32) for v in verts]
    mid_cache = {}

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in mid_cache:
            mid_cache[key] = len(vout)
            vout.append((vout[a] + vout[b]) * 0.5)
        return mid_cache[key]

    varr = np.asarray(vout, np.float32)
    tri = varr[faces]
    elen = np.stack([np.linalg.norm(tri[:, 1] - tri[:, 0], axis=1),
                     np.linalg.norm(tri[:, 2] - tri[:, 1], axis=1),
                     np.linalg.norm(tri[:, 0] - tri[:, 2], axis=1)], axis=1)
    long = elen > max_len

    fout = []
    for f, (a, b, c), flags in zip(range(len(faces)), faces, long):
        n_long = int(flags.sum())
        if n_long == 0:
            fout.append((a, b, c))
        elif n_long == 3:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            fout += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        else:
            # split the longest edge 1->2 (consistent midpoints keep the
            # mesh conforming across neighbors that split the same edge)
            e = int(np.argmax(elen[f]))
            if e == 0:
                m = midpoint(a, b)
                fout += [(a, m, c), (m, b, c)]
            elif e == 1:
                m = midpoint(b, c)
                fout += [(a, b, m), (a, m, c)]
            else:
                m = midpoint(c, a)
                fout += [(a, b, m), (b, c, m)]
    return np.asarray(vout, np.float32), np.asarray(fout, np.int64)


def collapse_short_edges(verts: np.ndarray, faces: np.ndarray,
                         min_len: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One pass of midpoint collapse of edges shorter than ``min_len``
    (Botsch-Kobbelt isotropic remeshing's collapse step). Each vertex
    participates in at most one collapse per pass; degenerate faces are
    dropped."""
    e = mesh_edges_np(faces)
    elen = np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1)
    order = np.argsort(elen)
    used = np.zeros(len(verts), bool)
    remap = np.arange(len(verts))
    new_pos = verts.astype(np.float32).copy()
    for i in order:
        if elen[i] >= min_len:
            break
        a, b = e[i]
        if used[a] or used[b]:
            continue
        used[a] = used[b] = True
        remap[b] = a
        new_pos[a] = 0.5 * (verts[a] + verts[b])
    f2 = remap[faces]
    keep = ((f2[:, 0] != f2[:, 1]) & (f2[:, 1] != f2[:, 2])
            & (f2[:, 2] != f2[:, 0]))
    f2 = f2[keep]
    # compact vertex ids
    uniq, inv = np.unique(f2, return_inverse=True)
    return new_pos[uniq], inv.reshape(-1, 3).astype(np.int64)


def flip_edges(verts: np.ndarray, faces: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One pass of valence-optimizing edge flips (Botsch-Kobbelt): an
    interior edge shared by exactly two triangles flips when that brings
    the four involved valences closer to the regular 6. Each face joins at
    most one flip per pass."""
    V = len(verts)
    valence = np.zeros(V, np.int64)
    edge_key = {}
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            k = (min(u, v), max(u, v))
            edge_key.setdefault(k, []).append(fi)
    for (u, v), fs in edge_key.items():
        valence[u] += 1
        valence[v] += 1

    faces = faces.copy()
    face_used = np.zeros(len(faces), bool)
    for (u, v), fs in edge_key.items():
        if len(fs) != 2:
            continue
        f0, f1 = fs
        if face_used[f0] or face_used[f1]:
            continue
        o0 = [x for x in faces[f0] if x != u and x != v]
        o1 = [x for x in faces[f1] if x != u and x != v]
        if len(o0) != 1 or len(o1) != 1 or o0[0] == o1[0]:
            continue
        a, b = o0[0], o1[0]
        dev_now = (abs(valence[u] - 6) + abs(valence[v] - 6)
                   + abs(valence[a] - 6) + abs(valence[b] - 6))
        # a flip removes edge (u, v) and adds (a, b)
        dev_flip = (abs(valence[u] - 1 - 6) + abs(valence[v] - 1 - 6)
                    + abs(valence[a] + 1 - 6) + abs(valence[b] + 1 - 6))
        if dev_flip >= dev_now:
            continue
        # geometric guard: keep the flipped pair non-degenerate
        n0 = np.cross(verts[b] - verts[a], verts[u] - verts[a])
        n1 = np.cross(verts[v] - verts[a], verts[b] - verts[a])
        if np.linalg.norm(n0) < 1e-12 or np.linalg.norm(n1) < 1e-12:
            continue
        # orient consistently with the original face f0 (a, u, v order)
        faces[f0] = (a, u, b)
        faces[f1] = (a, b, v)
        face_used[f0] = face_used[f1] = True
        valence[u] -= 1
        valence[v] -= 1
        valence[a] += 1
        valence[b] += 1
    return verts, faces


def tangential_relax(verts: np.ndarray, faces: np.ndarray,
                     iters: int = 3, step: float = 0.5) -> np.ndarray:
    """Tangential relaxation (Botsch-Kobbelt): move each vertex toward its
    neighbor centroid, projected back onto its tangent plane so the
    surface shape is preserved while triangle shapes equalize."""
    edges = mesh_edges_np(faces)
    V = len(verts)
    deg = np.zeros(V, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    deg = np.maximum(deg, 1)[:, None]
    v = verts.astype(np.float32).copy()
    for _ in range(iters):
        n = vertex_normals_np(v, np.asarray(faces))
        acc = np.zeros_like(v)
        np.add.at(acc, edges[:, 0], v[edges[:, 1]])
        np.add.at(acc, edges[:, 1], v[edges[:, 0]])
        d = acc / deg - v
        d = d - n * np.sum(d * n, axis=1, keepdims=True)   # tangent only
        v = v + step * d
    return v


def taubin_smooth(verts: np.ndarray, faces: np.ndarray,
                  lam: float = 0.5, mu: float = -0.53,
                  iters: int = 5) -> np.ndarray:
    """Taubin smoothing (volume-preserving laplacian; meshlab-style)."""
    edges = mesh_edges_np(faces)
    V = len(verts)
    deg = np.zeros(V, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    deg = np.maximum(deg, 1)[:, None]
    v = verts.astype(np.float32).copy()
    for _ in range(iters):
        for w in (lam, mu):
            acc = np.zeros_like(v)
            np.add.at(acc, edges[:, 0], v[edges[:, 1]])
            np.add.at(acc, edges[:, 1], v[edges[:, 0]])
            v = v + w * (acc / deg - v)
    return v


def remesh(verts: np.ndarray, faces: np.ndarray,
           target_len: float = 0.0, max_iters: int = 3
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Isotropic explicit remesh (Botsch-Kobbelt loop, the algorithm behind
    meshlab's ``remeshing_isotropic_explicit_remeshing``): per iteration,
    split edges > 4/3 L, collapse edges < 4/5 L, valence-optimizing flips,
    tangential relaxation; then a final Taubin smooth (the reference also
    laplacian-smooths first, mesh_util.py:112).

    Unlike split-only refinement this also *coarsens*, so irregular inputs
    (marching output mixes sliver and large triangles) converge toward
    uniform edge length L = ``target_len`` (default: current mean).

    Returns (verts, faces)."""
    if len(faces) == 0:
        return verts, faces
    if target_len <= 0:
        e = mesh_edges_np(faces)
        target_len = float(np.linalg.norm(
            verts[e[:, 0]] - verts[e[:, 1]], axis=1).mean())
    for _ in range(max_iters):
        verts, faces = split_long_edges(verts, faces,
                                        4.0 / 3.0 * target_len)
        verts, faces = collapse_short_edges(verts, faces,
                                            4.0 / 5.0 * target_len)
        verts, faces = flip_edges(verts, faces)
        verts = tangential_relax(verts, faces, iters=1)
    verts = taubin_smooth(verts, faces, iters=3)
    return verts, faces


def poisson_smooth(verts: np.ndarray, faces: np.ndarray,
                   iters: int = 10) -> np.ndarray:
    """Smoothing-only cleanup pass (see ops/poisson.py for the true
    screened-Poisson surface reconstruction replacing the reference's
    unused ``possion`` utility, mesh_util.py:123-133)."""
    return taubin_smooth(verts, faces, iters=iters)
