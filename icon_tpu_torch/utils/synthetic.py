"""Synthetic inputs of the serving frames (``icon_tpu.utils.synthetic``):
the posed clothed-human occupancy field in PyTorch (``clothed_human_sdf`` /
``clothed_human_occ``), the numpy ICON batch (``synthetic_icon_batch``) and
the demo's per-image item for the body fit (``synthetic_fit_item``).

The body mesh and the capsule skeleton come from the JAX package's numpy
helpers (``synthetic_body``, ``posed_skeleton``, ``_capsule_segments``);
the field evaluation is torch, on the device of the query points.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from icon_tpu.utils.synthetic import (_capsule_segments, posed_skeleton,
                                      synthetic_body)

__all__ = ["clothed_human_sdf", "clothed_human_occ", "synthetic_body",
           "synthetic_fit_item", "synthetic_icon_batch"]


def clothed_human_sdf(pts: torch.Tensor, pose: np.ndarray = None,
                      fold_amp: float = 0.010, fold_freq: float = 34.0,
                      fit_box: float = 0.88) -> torch.Tensor:
    """Approximate signed distance ``[...]`` (negative inside) to a posed,
    clothed human at ``pts [..., 3]`` in the recon box [-1, 1]^3: tapered
    bone capsules, smooth-min blended, minus two octaves of sinusoidal
    cloth folds below the neck. The body spans ``2 * fit_box`` of the
    box's y range."""
    joints = posed_skeleton(pose)
    a, b, ra, rb = _capsule_segments(joints)
    ymin = joints[:, 1].min() - 0.10           # sole below ankle
    ymax = joints[:, 1].max() + 0.16           # head sphere top
    scale = 2.0 * fit_box / (ymax - ymin)
    center = np.array([(joints[:, 0].min() + joints[:, 0].max()) / 2,
                       (ymin + ymax) / 2,
                       (joints[:, 2].min() + joints[:, 2].max()) / 2],
                      np.float32)
    a = (a - center) * scale
    b = (b - center) * scale
    ra, rb = ra * scale, rb * scale
    neck_y = float((joints[12, 1] - center[1]) * scale)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=pts.device)

    p = pts
    a_t, ab = t(a), t(b - a)                             # [K, 3]
    ap = p[..., None, :] - a_t                           # [..., K, 3]
    denom = torch.clamp(torch.sum(ab * ab, -1), min=1e-9)
    tt = torch.clamp(torch.sum(ap * ab, -1) / denom, 0.0, 1.0)
    closest = a_t + tt[..., None] * ab
    d = torch.linalg.norm(p[..., None, :] - closest, dim=-1)
    r = t(ra) + tt * t(rb - ra)
    sd = d - r                                           # [..., K]
    k = 35.0                                             # smooth-min union
    sdf = -(1.0 / k) * torch.log(torch.sum(torch.exp(-k * sd), dim=-1)
                                 + 1e-30)

    # cloth folds, tapered off above the neck and beyond ~6 cm from the skin
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    folds = (fold_amp * torch.sin(fold_freq * x + 1.3) *
             torch.sin(fold_freq * 0.83 * y) * torch.sin(fold_freq * 0.67 * z)
             + 0.5 * fold_amp * torch.sin(2.1 * fold_freq * y + 0.7) *
             torch.sin(1.9 * fold_freq * x))
    below_neck = torch.sigmoid((neck_y - y) * 40.0)
    near_skin = torch.exp(-(sdf / 0.06) ** 2)
    return sdf - folds * below_neck * near_skin


def clothed_human_occ(pts: torch.Tensor, pose: np.ndarray = None,
                      sharpness: float = 400.0, **kw) -> torch.Tensor:
    """Occupancy in [0, 1] of the posed clothed human (a sharp interface,
    like a trained net's sigmoid output)."""
    return torch.sigmoid(-clothed_human_sdf(pts, pose, **kw) * sharpness)


def synthetic_icon_batch(rng: np.random.RandomState, B: int = 1,
                         image_size: int = 512, n_samples: int = 8000,
                         subdiv: int = 5) -> Dict[str, np.ndarray]:
    """A full ICON-style in_tensor batch (numpy, NHWC images) with the
    synthetic body as its prior; draws from ``rng`` in the JAX package's
    order, so one seed gives both packages the same batch."""
    v, f = synthetic_body(subdiv)
    size = (B, image_size, image_size, 3)
    return {
        "image": rng.randn(*size).astype(np.float32),
        "normal_F": rng.randn(*size).astype(np.float32),
        "normal_B": rng.randn(*size).astype(np.float32),
        "sample": (rng.rand(B, n_samples, 3) * 2 - 1).astype(np.float32),
        "label": (rng.rand(B, n_samples, 1) > 0.5).astype(np.float32),
        "calib": np.tile(np.eye(4, dtype=np.float32)[None], (B, 1, 1)),
        "smpl_verts": np.tile(v[None], (B, 1, 1)),
        "smpl_faces": f,
        "smpl_cmap": np.tile(((v - v.min(0)) /
                              (v.max(0) - v.min(0)))[None], (B, 1, 1)),
        "smpl_vis": (np.tile(v[None, :, 2:3], (B, 1, 1)) > 0).astype(
            np.float32),
    }


def synthetic_fit_item(body, size: int, seed: int = 0) -> Dict[str, object]:
    """The demo's per-image inputs of the body fit (``apps/infer.py``'s
    ``<name>_smpl.npz`` override path), as numpy, for the port's
    ``BodyModel`` ``body``: the body at a seeded target pose (every joint's
    rotation 0.1 rad of axis-angle, betas, a small translation); its
    ``size``^2 silhouette as the ``mask``; an ``image`` of seeded noise
    inside the mask and zero outside (a matted crop); ``init``: the target's
    rotations times seeded 0.05 rad offsets through ``batch_rodrigues``, and
    perturbed betas and translation; ``scale`` 1; and the demo's ``calib``
    (``make_calib(0.0)``: y and z flipped). The mask is drawn with face
    lists long enough that no face is dropped."""
    from icon_tpu_torch.models.smplx.lbs import batch_rodrigues
    from icon_tpu_torch.ops.raster import rasterize
    from icon_tpu_torch.render.camera import verts_to_ndc

    rng = np.random.RandomState(seed)
    J = body.num_joints
    dev = body.v_template.device

    def rotations(aa):
        return batch_rodrigues(torch.from_numpy(aa.astype(np.float32)))

    rot = rotations(rng.randn(J, 3) * 0.1)
    betas = (rng.randn(1, body.num_betas) * 0.5).astype(np.float32)
    trans = (rng.randn(3) * 0.02).astype(np.float32)
    init_rot = (rot @ rotations(rng.randn(J, 3) * 0.05)).numpy()
    with torch.no_grad():
        v, _ = body(betas=torch.from_numpy(betas).to(dev),
                    global_orient=rot[:1].reshape(1, 9).to(dev),
                    body_pose=rot[1:].reshape(1, -1).to(dev), pose2rot=False)
        verts = v[0] + torch.from_numpy(trans).to(dev)
        faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.int64,
                                device=dev)
        out = rasterize(verts_to_ndc(verts), faces, verts[:, :1], H=size,
                        W=size, K=min(2048, len(faces)))
    if int(out.bin_overflow):
        raise ValueError(f"the {size}^2 mask would drop "
                         f"{int(out.bin_overflow)} (tile, face) pairs")
    mask = out.mask.cpu().numpy()
    image = rng.uniform(-1, 1, (size, size, 3)).astype(np.float32) * \
        mask[..., None]
    init = {"betas": betas + (rng.randn(*betas.shape) * 0.1).astype(
                np.float32),
            "body_pose": init_rot[None, 1:],
            "global_orient": init_rot[None, :1],
            "trans": trans + (rng.randn(3) * 0.01).astype(np.float32)}
    return {"image": image, "mask": mask, "init": init, "scale": 1.0,
            "calib": np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)}
