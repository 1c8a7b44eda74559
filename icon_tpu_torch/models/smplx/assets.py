"""SMPL-related asset registry (a copy of ``icon_tpu.models.smplx.assets``'s
``data_root``, ``SMPLX`` and ``get_smpl_model``; reference
lib/dataset/mesh_util.py:830-886 and lib/renderer/mesh.py:25-43).

The on-disk layout is the reference's ``data/smpl_related`` tree, under
``$ICON_TPU_DATA_DIR`` (default ``<repo>/data``), the same variable the JAX
package reads, so one ``data/`` tree serves both packages::

    data/smpl_related/smpl_data/{smpl,smplx}_verts.npy, smplx_faces.npy,
                                smplx_cmap.npy
    data/smpl_related/models/{smpl,smplx}/...
"""

from __future__ import annotations

import functools
import os
import os.path as osp
from typing import Optional

import numpy as np


def data_root() -> str:
    here = osp.dirname(osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(__file__)))))
    return os.environ.get("ICON_TPU_DATA_DIR", osp.join(here, "data"))


class SMPLX:
    """Lazy paths and arrays of the SMPL-X helper assets."""

    def __init__(self, root: Optional[str] = None):
        self.current_dir = osp.join(root or data_root(), "smpl_related")
        sd = osp.join(self.current_dir, "smpl_data")
        self.smpl_verts_path = osp.join(sd, "smpl_verts.npy")
        self.smplx_verts_path = osp.join(sd, "smplx_verts.npy")
        self.faces_path = osp.join(sd, "smplx_faces.npy")
        self.cmap_vert_path = osp.join(sd, "smplx_cmap.npy")
        self.model_dir = osp.join(self.current_dir, "models")
        self.tedra_dir = osp.join(osp.dirname(self.current_dir),
                                  "tedra_data")

    @functools.cached_property
    def verts(self) -> np.ndarray:
        return np.load(self.smplx_verts_path)

    @functools.cached_property
    def smpl_verts(self) -> np.ndarray:
        return np.load(self.smpl_verts_path)

    @functools.cached_property
    def cmap(self) -> np.ndarray:
        return np.load(self.cmap_vert_path).astype(np.float32)

    def cmap_smpl_vids(self, type_: str = "smplx") -> np.ndarray:
        """The per-vertex colour map; for ``type_`` 'smpl' remapped through
        each SMPL vertex's nearest SMPL-X vertex."""
        if type_ == "smplx":
            return self.cmap
        from scipy.spatial import cKDTree
        tree = cKDTree(self.verts, leafsize=1)
        _, ind = tree.query(self.smpl_verts, k=1)
        return self.cmap[ind]


def get_smpl_model(model_type: str = "smplx", gender: str = "male",
                   root: Optional[str] = None):
    """The body model ``<MODEL_TYPE>_<GENDER>.{npz,pkl}`` of the registry's
    model directory when it is installed, else the synthetic SMPL-X
    stand-in ``synthetic_smplx_model(subdiv=4)`` (the licensed files cannot
    be redistributed). Each call builds a new ``BodyModel`` on the CPU: the
    caller may move it to its device."""
    from icon_tpu_torch.models.smplx.body import (load_body_model,
                                                  synthetic_smplx_model)
    mdir = osp.join(SMPLX(root).model_dir, model_type)
    for ext in ("npz", "pkl"):
        p = osp.join(mdir, f"{model_type.upper()}_{gender.upper()}.{ext}")
        if osp.exists(p):
            return load_body_model(p, model_type=model_type)
    return synthetic_smplx_model(subdiv=4)
