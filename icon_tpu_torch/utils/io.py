"""Host mesh utilities (a copy of ``icon_tpu.utils.io.clean_mesh``,
reference ``mesh_util.py:778-791``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
