"""Host mesh and media IO (copies of ``icon_tpu.utils.io``'s ``save_obj``,
``load_obj``, ``clean_mesh``, ``save_gif`` and ``save_video``; reference
``mesh_util.py:523-683,778-791``)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Write an OBJ (vertex colours appended to the ``v`` lines, the common
    extension the reference's coloured exports rely on)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces).astype(np.int64) + 1
    lines = []
    if colors is not None:
        c = np.asarray(colors, np.float32)
        for p, col in zip(v, c):
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                         f"{col[0]:.4f} {col[1]:.4f} {col[2]:.4f}")
    else:
        for p in v:
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    for tri in f:
        lines.append(f"f {tri[0]} {tri[1]} {tri[2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader (``v``/``f`` lines; polygons fan-triangulated)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int64).reshape(-1, 3))


def clean_mesh(verts: np.ndarray, faces: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the largest connected component: scipy's sparse connected
    components on the vertex-adjacency graph."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    f = np.asarray(faces)
    V = len(verts)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
    n_comp, labels = connected_components(adj, directed=False)
    if n_comp <= 1:
        return np.asarray(verts), f
    largest = np.argmax(np.bincount(labels))
    keep_v = labels == largest
    remap = -np.ones(V, np.int64)
    remap[keep_v] = np.arange(keep_v.sum())
    keep_f = keep_v[f].all(axis=1)
    return np.asarray(verts)[keep_v], remap[f[keep_f]]


def save_gif(path: str, frames, fps: int = 30) -> None:
    """Frames ``[H, W, 3]`` uint8 as a looping GIF (PIL)."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1000 // fps, 20), loop=0)


def save_video(path: str, frames, fps: int = 30) -> None:
    """Frames ``[H, W, 3]`` uint8 RGB as an MP4 (OpenCV, ``mp4v``; the
    reference's video deliverable)."""
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for fr in frames:
        vw.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    vw.release()
