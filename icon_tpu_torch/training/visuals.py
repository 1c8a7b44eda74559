"""What the geometry network predicts, as images for the training log
(``icon_tpu.training.visuals``; reference render_func, apps/ICON.py:
694-727):

- :func:`point_error_image`: the batch's sample points splatted into an
  image, green where the prediction is on the label's side, red where not
  (a copy of the JAX function);
- :func:`occupancy_slice_image`: a dense slice of the occupancy field
  through the origin, a low-resolution preview without the engine;
- :func:`normal_pred_panels`: the NormalNet trainer's panels (a copy of
  the JAX function).

They return numpy arrays for ``MetricLogger.log_images``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def point_error_image(xy: np.ndarray, pred: np.ndarray, label: np.ndarray,
                      size: int = 256) -> np.ndarray:
    """Splat sampled query points into a [size, size, 3] image colored by
    occupancy error: green = |pred - label| ~ 0, red = wrong side.

    xy: [N, 2] point positions in [-1, 1] (calib/NDC x right, y up).
    pred/label: [N] or [N, 1] occupancy in [0, 1].
    """
    xy = np.asarray(xy, np.float32).reshape(-1, 2)
    pred = np.asarray(pred, np.float32).reshape(-1)
    label = np.asarray(label, np.float32).reshape(-1)
    err = np.clip(np.abs(pred - label), 0.0, 1.0)
    px = np.clip(((xy[:, 0] * 0.5 + 0.5) * (size - 1)).round().astype(int),
                 0, size - 1)
    # y up in NDC -> row 0 at the top
    py = np.clip(((-xy[:, 1] * 0.5 + 0.5) * (size - 1)).round().astype(int),
                 0, size - 1)
    img = np.zeros((size, size, 3), np.float32)
    img[py, px, 0] = err                  # red: wrong
    img[py, px, 1] = 1.0 - err            # green: right
    return img


@torch.no_grad()
def occupancy_slice_image(model: torch.nn.Module,
                          batch: Dict[str, torch.Tensor], res: int = 65,
                          axis: str = "z") -> np.ndarray:
    """The first item's occupancy on a ``res``^2 slice through the origin
    (plane xy for ``axis`` z, xz for y, yz for x), in eval mode, signed by
    ray bins built from its body. Returns [res, res, 3] grey in [0, 1]."""
    from icon_tpu_torch.data.datasets import MAP_KEYS, SHARED_KEYS
    from icon_tpu_torch.ops.sdf_fast import build_ray_bins
    was_training = model.training
    model.eval()
    dev = batch["calib"].device
    one = {k: (v if k in SHARED_KEYS else v[:1]) for k, v in batch.items()
           if torch.is_tensor(v)}
    features = model.filter({k: one[k] for k in MAP_KEYS if k in one})
    smpl = {k: v for k, v in one.items()
            if k.startswith(("smpl_", "voxel_")) and k != "smpl_query_inside"}
    if "smpl_vf_table" in smpl:
        rb, rg = build_ray_bins(smpl["smpl_verts"][0].cpu().numpy(),
                                smpl["smpl_faces"].cpu().numpy())
        smpl["smpl_ray_bins"] = torch.from_numpy(rb).to(dev)
        smpl["smpl_ray_grid"] = torch.from_numpy(rg).to(dev)
    g = torch.linspace(-1.0, 1.0, res, device=dev)
    b, a = torch.meshgrid(g, g, indexing="ij")
    zeros = torch.zeros_like(a)
    pts = {"z": (a, -b, zeros), "y": (a, zeros, b),
           "x": (zeros, -b, a)}[axis]
    pts = torch.stack(pts, -1).reshape(1, -1, 3)
    pred = model.query(features, pts, one["calib"], smpl or None)[-1]
    model.train(was_training)
    sl = pred.reshape(res, res, 1).clamp(0.0, 1.0).cpu().numpy()
    return sl.repeat(3, axis=-1)


def normal_pred_panels(batch: Dict[str, np.ndarray],
                       pred_F: np.ndarray,
                       pred_B: Optional[np.ndarray] = None
                       ) -> Dict[str, np.ndarray]:
    """Panel dict for the normal trainer (reference Normal.py:117-129
    render_func: [image, T_normal_F, pred, gt])."""
    out = {}
    if "image" in batch:
        out["image"] = np.asarray(batch["image"])[0]
    if "T_normal_F" in batch:
        out["T_normal_F"] = np.asarray(batch["T_normal_F"])[0]
    out["pred_F"] = np.asarray(pred_F)[0]
    if "normal_F" in batch:
        out["gt_F"] = np.asarray(batch["normal_F"])[0]
    if pred_B is not None:
        out["pred_B"] = np.asarray(pred_B)[0]
        if "normal_B" in batch:
            out["gt_B"] = np.asarray(batch["normal_B"])[0]
    return out
