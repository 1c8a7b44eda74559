"""Mesh regularization losses of the cloth-refinement loop
(``icon_tpu.ops.mesh_losses``; the PyTorch3D losses of the reference's
``update_mesh_shape_prior_losses``, lib/dataset/mesh_util.py:168-184):
uniform Laplacian smoothing, mean edge length and normal consistency, as
gathers and ``index_add_`` over a static topology. The topology tables are
host numpy, built once per mesh."""

from __future__ import annotations

import numpy as np
import torch

from icon_tpu_torch.ops.mesh import face_normals


def mesh_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges ``[E, 2]`` (host)."""
    f = np.asarray(faces)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def edge_face_adjacency(faces: np.ndarray) -> np.ndarray:
    """``[Ei, 2]`` pairs of faces that share an interior edge (host)."""
    f = np.asarray(faces)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e = np.sort(e, axis=1)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e_sorted = e[order]
    # rows are stacked per edge slot: [0,F) slot 0, [F,2F) slot 1, [2F,3F) 2
    face_of_row = np.tile(np.arange(len(f)), 3)[order]
    same = np.all(e_sorted[1:] == e_sorted[:-1], axis=1)
    pairs = np.stack([face_of_row[:-1][same], face_of_row[1:][same]], axis=1)
    return pairs.astype(np.int32)


def laplacian_loss(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Uniform Laplacian smoothing: mean ||v_i - mean(neighbours)||
    (pytorch3d ``mesh_laplacian_smoothing``, 'uniform'). ``edges [E, 2]``
    int64."""
    i, j = edges[:, 0], edges[:, 1]
    acc = torch.zeros_like(verts)
    acc.index_add_(0, i, verts[j])
    acc.index_add_(0, j, verts[i])
    ones = verts.new_ones((edges.shape[0], 1))
    deg = verts.new_zeros((verts.shape[0], 1))
    deg.index_add_(0, i, ones)
    deg.index_add_(0, j, ones)
    lap = verts - acc / torch.clamp(deg, min=1.0)
    return torch.mean(torch.sqrt(torch.sum(lap * lap, dim=-1) + 1e-12))


def edge_length_loss(verts: torch.Tensor, edges: torch.Tensor,
                     target: float = 0.0) -> torch.Tensor:
    """Mean squared edge length (pytorch3d ``mesh_edge_loss``)."""
    d = verts[edges[:, 0]] - verts[edges[:, 1]]
    return torch.mean((torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
                       - target) ** 2)


def normal_consistency_loss(verts: torch.Tensor, faces: torch.Tensor,
                            face_pairs: torch.Tensor) -> torch.Tensor:
    """1 - cos between adjacent face normals (pytorch3d
    ``mesh_normal_consistency``)."""
    fn = face_normals(verts[None], faces)[0]
    n0 = fn[face_pairs[:, 0]]
    n1 = fn[face_pairs[:, 1]]
    return torch.mean(1.0 - torch.sum(n0 * n1, dim=-1))
