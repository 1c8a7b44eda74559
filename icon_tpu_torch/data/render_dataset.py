"""The demo's camera calibration (a copy of
``icon_tpu.data.render_dataset.make_calib``; the offline dataset renders
of that module are ROADMAP Queue A item 11)."""

from __future__ import annotations

import math

import numpy as np


def make_calib(azimuth_deg: float, scale: float = 1.0) -> np.ndarray:
    """8x4 calib file contents: extrinsic (4x4) over intrinsic (4x4).

    ``intrinsic @ extrinsic`` maps world vertices (y up, the [-1, 1] box) to
    the rasterizer's NDC frame: x right, y down, smaller z closer (the same
    [1, -1, -1] flip as ``render.camera.verts_to_ndc``)."""
    a = math.radians(azimuth_deg)
    c, s = math.cos(a), math.sin(a)
    extrinsic = np.array([[c, 0, -s, 0],
                          [0, 1, 0, 0],
                          [s, 0, c, 0],
                          [0, 0, 0, 1]], np.float32)
    intrinsic = np.diag([scale, -scale, -scale, 1.0]).astype(np.float32)
    return np.concatenate([extrinsic, intrinsic], axis=0)
