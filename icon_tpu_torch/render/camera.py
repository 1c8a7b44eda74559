"""Orthographic turntable camera (``icon_tpu.render.camera``; reference
lib/common/render.py:120-180, PyTorch3D FoVOrthographicCameras at azimuths
0/90/180/270): meshes live in [-1, 1]^3 with y up; image rows run top-down.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from icon_tpu_torch.ops.constants import device_constant


def view_matrix(azimuth_deg: float) -> np.ndarray:
    """Rotation ``[3, 3]`` bringing world verts into the camera frame at an
    azimuth about the y axis (the mesh turns by -azimuth; the camera looks
    along +z)."""
    a = math.radians(azimuth_deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, -s],
                     [0.0, 1.0, 0.0],
                     [s, 0.0, c]], np.float32)


def verts_to_ndc(verts: torch.Tensor, azimuth_deg: float = 0.0
                 ) -> torch.Tensor:
    """World verts ``[V, 3]`` (y up) -> rasterizer NDC: x right, y down,
    smaller z closer (the front, +z, faces the camera at azimuth 0)."""
    R = device_constant(view_matrix(azimuth_deg), verts.dtype, verts.device)
    flip = device_constant([1.0, -1.0, -1.0], verts.dtype, verts.device)
    return (verts @ R.T) * flip


def ortho_views() -> Tuple[float, ...]:
    """The reference's four evaluation azimuths (render.py:150)."""
    return (0.0, 90.0, 180.0, 270.0)
