"""Reconstruction metrics (``icon_tpu.eval.evaluator``; reference
lib/dataset/Evaluator.py).

- Chamfer and P2S over 1,000 area-weighted surface samples, x100
  (Evaluator.py:200-230): the samples' exact distances to the other mesh
  (``ops/sdf.py:point_mesh_dist_winding``, on the device of the caller's
  choice); chamfer is the mean of the two one-sided distances, P2S the
  ground truth's samples to the prediction.
- Normal consistency: both meshes' normal images at azimuths 0/90/180/270
  through ``render_normal`` (on the card, the raster kernels), the mean
  squared difference per view, summed (Evaluator.py:125-177).
- Occupancy accuracy, IoU, precision and recall at 0.5
  (Evaluator.py:232-263).

:func:`sample_surface` and :func:`occupancy_metrics` are copies of the JAX
module's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from icon_tpu_torch.ops.sdf import point_mesh_dist_winding
from icon_tpu_torch.render.camera import ortho_views
from icon_tpu_torch.render.render import render_normal


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 1993) -> np.ndarray:
    """Area-weighted uniform surface samples (trimesh.sample equivalent)."""
    rng = np.random.RandomState(seed)
    v = np.asarray(verts)
    f = np.asarray(faces)
    tris = v[f]                                        # [F, 3, 3]
    cross = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    prob = area / max(area.sum(), 1e-12)
    pick = rng.choice(len(f), size=n, p=prob)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    t = tris[pick]
    return ((1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1] +
            r1 * r2 * t[:, 2]).astype(np.float32)


def _point_to_mesh(points: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                   device) -> np.ndarray:
    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=device)
    p = torch.as_tensor(np.asarray(points, np.float32), device=device)
    d2, _, _ = point_mesh_dist_winding(p, v[f])
    return torch.sqrt(d2).cpu().numpy()


def chamfer_p2s(pred_verts: np.ndarray, pred_faces: np.ndarray,
                gt_verts: np.ndarray, gt_faces: np.ndarray,
                num_samples: int = 1000, seed: int = 1993,
                device="cuda") -> Tuple[float, float]:
    """(chamfer, p2s), both x100 (the reference's convention)."""
    pred_samples = sample_surface(pred_verts, pred_faces, num_samples, seed)
    gt_samples = sample_surface(gt_verts, gt_faces, num_samples, seed + 1)
    d_pred_to_gt = _point_to_mesh(pred_samples, gt_verts, gt_faces,
                                  device).mean()
    d_gt_to_pred = _point_to_mesh(gt_samples, pred_verts, pred_faces,
                                  device).mean()
    p2s = 100.0 * d_gt_to_pred
    chamfer = 100.0 * 0.5 * (d_pred_to_gt + d_gt_to_pred)
    return float(chamfer), float(p2s)


@torch.no_grad()
def normal_consistency(pred_verts: np.ndarray, pred_faces: np.ndarray,
                       gt_verts: np.ndarray, gt_faces: np.ndarray,
                       size: int = 512, device="cuda") -> float:
    """Mean squared normal-image difference over the 4 orthographic views,
    summed over the views."""
    meshes = [(torch.as_tensor(np.asarray(v, np.float32), device=device),
               torch.as_tensor(np.asarray(f), dtype=torch.int64,
                               device=device))
              for v, f in ((pred_verts, pred_faces), (gt_verts, gt_faces))]
    total = 0.0
    for az in ortho_views():
        (n_pred, _), (n_gt, _) = [render_normal(v, f, size=size, azimuth=az)
                                  for v, f in meshes]
        total += float(((n_pred - n_gt) ** 2).sum(-1).mean())
    return total


def occupancy_metrics(pred, label, thresh: float = 0.5) -> Dict[str, float]:
    """acc / IoU / precision / recall at a threshold
    (Evaluator.py:232-263)."""
    p = np.asarray(pred) > thresh
    l = np.asarray(label) > thresh
    tp = float(np.sum(p & l))
    fp = float(np.sum(p & ~l))
    fn = float(np.sum(~p & l))
    tn = float(np.sum(~p & ~l))
    return {
        "acc": (tp + tn) / max(tp + tn + fp + fn, 1.0),
        "iou": tp / max(tp + fp + fn, 1.0),
        "prec": tp / max(tp + fp, 1.0),
        "recall": tp / max(tp + fn, 1.0),
    }
