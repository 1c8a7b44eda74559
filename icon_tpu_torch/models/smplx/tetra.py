"""Tetrahedral SMPL for PaMIR's semantic voxelization
(``icon_tpu.models.smplx.tetra``; reference lib/dataset/body_model.py:
234-494, TetraSMPLModel).

The tetra model is the base SMPL plus extra interior vertices (the
``*_added`` arrays of the reference's preprocessed asset); both vertex sets
share the same LBS, so the templates, shape and pose blend shapes and
skinning weights are concatenated into one :class:`BodyModel`.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np

from icon_tpu_torch.models.smplx.body import BodyModel, _to_np


def load_tetra_body_model(model_path: str, addition_path: str,
                          age: str = "adult",
                          v_template: Optional[np.ndarray] = None
                          ) -> Tuple[BodyModel, dict]:
    """SMPL (``model_path``, a release ``.pkl``) with the tetra additions
    (``addition_path``, ``tetra_*.npz``).

    Returns (model, extras): ``model.v_template`` holds the surface and the
    added vertices, surface first (the reference's voxel_verts order);
    ``extras`` carries ``n_surface`` and ``tetrahedrons``. ``age`` is
    accepted for the JAX package's signature and not read."""
    with open(model_path, "rb") as f:
        params = pickle.load(f, encoding="latin1")
    added = np.load(addition_path)

    vt = (_to_np(params["v_template"]) if v_template is None
          else np.asarray(v_template)).astype(np.float32)
    n_surface = len(vt)

    v_all = np.concatenate(
        [vt, added["v_template_added"].astype(np.float32)])
    shapedirs = np.concatenate(
        [_to_np(params["shapedirs"]).astype(np.float32),
         added["shapedirs_added"].astype(np.float32)])
    weights = np.concatenate(
        [_to_np(params["weights"]).astype(np.float32),
         added["weights_added"].astype(np.float32)])

    posedirs = np.concatenate(
        [_to_np(params["posedirs"]).astype(np.float32),     # [V, 3, P]
         added["posedirs_added"].astype(np.float32)])
    posedirs_flat = posedirs.reshape(-1, posedirs.shape[-1]).T

    J_reg = _to_np(params["J_regressor"]).astype(np.float32)
    # the regressor only sees surface vertices: zeros for the added ones
    J_reg_full = np.concatenate(
        [J_reg, np.zeros((J_reg.shape[0], len(v_all) - J_reg.shape[1]),
                         np.float32)], axis=1)

    parents = _to_np(params["kintree_table"])[0].astype(np.int64)
    parents[0] = 0

    model = BodyModel(
        v_template=v_all, shapedirs=shapedirs, posedirs=posedirs_flat,
        J_regressor=J_reg_full, lbs_weights=weights,
        faces=_to_np(params["f"]).astype(np.int32),
        parents=tuple(int(p) for p in parents), model_type="tetra_smpl",
        num_betas=10)
    extras = {"n_surface": n_surface,
              "tetrahedrons": added["tetrahedrons"].astype(np.int32)}
    return model, extras
