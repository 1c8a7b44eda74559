"""Synthetic inputs of the serving frames (``icon_tpu.utils.synthetic``):
the posed clothed-human occupancy field in PyTorch (``clothed_human_sdf`` /
``clothed_human_occ``), the numpy ICON batch (``synthetic_icon_batch``), the demo's per-image
item for the body fit (``synthetic_fit_item``), the demo's input photos
(``synthetic_photos``), HGPIFuNet weights whose occupancy is the body's
(``sdf_readout``; ``prior_readout`` for every prior), and a directory of
the demo CLI's inputs (``write_demo_inputs``).

The body mesh and the capsule skeleton are copies of the JAX package's
numpy helpers (``icosphere``, ``synthetic_body``, ``posed_skeleton``,
``_capsule_segments`` and their tables); the field evaluation is torch, on
the device of the query points.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["clothed_human_sdf", "clothed_human_occ", "prior_readout",
           "sdf_readout",
           "synthetic_body", "synthetic_fit_item", "synthetic_icon_batch",
           "synthetic_photos", "write_demo_inputs"]


def icosphere(subdiv: int = 5, radius: float = 1.0):
    """Unit icosphere; subdiv 5 -> 10242 verts, 20480 faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdiv):
        cache = {}
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                m = m / np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        faces = np.array(new_faces, np.int64)
        verts = np.array(verts)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def synthetic_body(subdiv: int = 5, scale: float = 0.55,
                   squash: Tuple[float, float, float] = (0.45, 1.0, 0.3)):
    """A body-proportioned ellipsoid mesh at SMPL-X face count."""
    v, f = icosphere(subdiv)
    v = v * np.array(squash, np.float32) * scale
    return v, f


# ---------------------------------------------------------------------------
# Posed capsule-skeleton human: an analytic clothed-human occupancy field for
# benchmarking. The recon engine's cost follows the *boundary area* of the
# level set (per-level candidate counts); an ellipsoid understates a clothed
# human's by ~3x (recon/engine.py:50-56), so the bench field is a human:
# SMPL-topology kinematic tree posed by forward kinematics with a real
# THuman2 fit's joint rotations, capsules along every bone, plus
# high-frequency sinusoidal "cloth fold" displacement below the neck.
# ---------------------------------------------------------------------------

# SMPL 24-joint kinematic tree (parents as in lib/smplx/lbs.py usage).
SMPL_PARENTS = np.array([
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 20, 21], np.int32)

# Approximate average-adult rest-pose joint positions (meters, y-up, pelvis
# at origin). These are generic body proportions, not SMPL model data.
REST_JOINTS = np.array([
    [0.000, 0.000, 0.000],    # 0  pelvis
    [0.090, -0.080, 0.005],   # 1  l_hip
    [-0.090, -0.080, 0.005],  # 2  r_hip
    [0.000, 0.110, 0.005],    # 3  spine1
    [0.105, -0.465, 0.000],   # 4  l_knee
    [-0.105, -0.465, 0.000],  # 5  r_knee
    [0.000, 0.230, 0.010],    # 6  spine2
    [0.100, -0.845, -0.025],  # 7  l_ankle
    [-0.100, -0.845, -0.025], # 8  r_ankle
    [0.000, 0.300, 0.010],    # 9  spine3
    [0.110, -0.900, 0.095],   # 10 l_foot
    [-0.110, -0.900, 0.095],  # 11 r_foot
    [0.000, 0.470, 0.005],    # 12 neck
    [0.060, 0.420, 0.000],    # 13 l_collar
    [-0.060, 0.420, 0.000],   # 14 r_collar
    [0.000, 0.580, 0.020],    # 15 head
    [0.170, 0.440, 0.000],    # 16 l_shoulder
    [-0.170, 0.440, 0.000],   # 17 r_shoulder
    [0.430, 0.430, 0.000],    # 18 l_elbow
    [-0.430, 0.430, 0.000],   # 19 r_elbow
    [0.670, 0.430, 0.000],    # 20 l_wrist
    [-0.670, 0.430, 0.000],   # 21 r_wrist
    [0.755, 0.430, 0.000],    # 22 l_hand
    [-0.755, 0.430, 0.000],   # 23 r_hand
], np.float32)

# (joint_a, joint_b, radius_a, radius_b) capsules along bones. Radii taper
# toward the extremities like a real body.
BONE_CAPSULES = (
    (0, 3, 0.125, 0.120),    # pelvis->spine1
    (3, 6, 0.120, 0.115),    # spine1->spine2
    (6, 9, 0.115, 0.110),    # spine2->spine3
    (9, 12, 0.095, 0.055),   # spine3->neck
    (12, 15, 0.050, 0.055),  # neck->head
    (15, 15, 0.100, 0.100),  # head sphere
    (1, 2, 0.105, 0.105),    # hip bar
    (13, 16, 0.060, 0.055),  # l clavicle->shoulder
    (14, 17, 0.060, 0.055),  # r
    (1, 4, 0.085, 0.060),    # l thigh
    (2, 5, 0.085, 0.060),    # r thigh
    (4, 7, 0.058, 0.042),    # l shin
    (5, 8, 0.058, 0.042),    # r shin
    (7, 10, 0.042, 0.035),   # l foot
    (8, 11, 0.042, 0.035),   # r foot
    (16, 18, 0.050, 0.040),  # l upper arm
    (17, 19, 0.050, 0.040),  # r
    (18, 20, 0.040, 0.032),  # l forearm
    (19, 21, 0.040, 0.032),  # r
    (20, 22, 0.036, 0.025),  # l hand
    (21, 23, 0.036, 0.025),  # r
)

# Joint rotations (axis-angle, SMPL joint order: global_orient + 21 body
# joints; hands/feet identity) of the THuman2.0 subject-0525 SMPL-X fit
# shipped with the reference as sample data
# (sample_data/thuman2/fits/0525/smplx_param.pkl) — fit
# *parameters* of a public dataset sample, embedded so the bench needs no
# external files. The pose is a natural standing pose with bent arms.
THUMAN2_0525_POSE = np.array([
    0.0378, 0.4628, -0.2276,             # global_orient
    -0.5782, 0.0263, 0.418,              # 1 l_hip
    0.1329, -0.174, 0.074,               # 2 r_hip
    0.0615, 0.1032, -0.0296,             # 3 spine1
    0.3089, -0.0784, 0.021,              # 4 l_knee
    -0.0755, -0.0323, 0.1927,            # 5 r_knee
    -0.1412, -0.0212, 0.1142,            # 6 spine2
    0.1994, -0.0162, -0.2544,            # 7 l_ankle
    -0.2169, -0.208, 0.0462,             # 8 r_ankle
    0.1161, -0.0387, 0.0725,             # 9 spine3
    -0.40089, 0.026784, 0.11078,         # 10 l_foot
    0.1681, 0.038684, -0.00048756,       # 11 r_foot
    -0.052921, -0.58196, 0.25597,        # 12 neck
    0.0293, 0.2919, 0.126,               # 13 l_collar
    -0.3952, -0.1603, -0.0656,           # 14 r_collar
    -0.0172, -0.5763, -0.0225,           # 15 head
    0.4978, -0.4615, -0.8853,            # 16 l_shoulder
    -0.0846, 0.6482, 0.3235,             # 17 r_shoulder
    1.306, -1.94, -0.3282,               # 18 l_elbow
    0.1771, 0.1544, -0.1926,             # 19 r_elbow
    -0.5447, -0.6193, 0.4241,            # 20 l_wrist
    0.1643, 0.3154, -0.9383,             # 21 r_wrist
    0.0, 0.0, 0.0,                       # 22 l_hand
    0.0, 0.0, 0.0,                       # 23 r_hand
], np.float32).reshape(24, 3)


def posed_skeleton(pose: np.ndarray = None) -> np.ndarray:
    """Forward kinematics -> [24, 3] posed joint positions (numpy).

    ``pose`` is [24, 3] axis-angle (SMPL joint order); default is the
    embedded THuman2-0525 standing pose.
    """
    if pose is None:
        pose = THUMAN2_0525_POSE
    pose = np.asarray(pose, np.float64)

    def rodrigues(v):
        ang = np.linalg.norm(v)
        if ang < 1e-9:
            return np.eye(3)
        k = v / ang
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)

    R_world = [None] * 24
    pos = np.zeros((24, 3))
    for j in range(24):
        R = rodrigues(pose[j])
        p = SMPL_PARENTS[j]
        if p < 0:
            R_world[j] = R
            pos[j] = REST_JOINTS[j]
        else:
            pos[j] = pos[p] + R_world[p] @ (REST_JOINTS[j] - REST_JOINTS[p])
            R_world[j] = R_world[p] @ R
    return pos.astype(np.float32)


def _capsule_segments(joints: np.ndarray):
    """Capsule endpoints + radii from posed joints: ([K,3], [K,3], [K],
    [K])."""
    a = np.stack([joints[c[0]] for c in BONE_CAPSULES])
    b = np.stack([joints[c[1]] for c in BONE_CAPSULES])
    ra = np.array([c[2] for c in BONE_CAPSULES], np.float32)
    rb = np.array([c[3] for c in BONE_CAPSULES], np.float32)
    return (a.astype(np.float32), b.astype(np.float32), ra, rb)


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


def synthetic_photos(body, size: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Two uint8 photos of the ``BodyModel`` ``body``'s rest-pose
    silhouette at ``size``^2, for the demo's two preprocessing paths: RGBA,
    colour noise with the silhouette as alpha (the matte path), and RGB,
    the same figure over a smooth textured background (the saliency
    path)."""
    from icon_tpu_torch.ops.raster import rasterize
    from icon_tpu_torch.render.camera import verts_to_ndc

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        v, _ = body()
        verts = v[0].cpu() * 0.8
        faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.int64)
        out = rasterize(verts_to_ndc(verts), faces, verts[:, :1], H=size,
                        W=size, K=min(2048, len(faces)))
    mask = out.mask.numpy() > 0.5
    figure = (rng.rand(size, size, 3) * 255).astype(np.uint8)
    rgba = np.concatenate([figure, (mask * 255).astype(np.uint8)[..., None]],
                          axis=-1)
    yy, xx = np.mgrid[:size, :size] / float(size)
    back = np.stack([0.35 + 0.1 * np.sin(6.0 * xx + 2.0 * yy),
                     0.55 + 0.1 * np.sin(4.0 * yy),
                     0.30 + 0.05 * np.cos(5.0 * xx)], axis=-1)
    back = np.clip(back + 0.02 * rng.randn(size, size, 3), 0.0, 1.0)
    rgb = np.where(mask[..., None], figure, (back * 255).astype(np.uint8))
    return rgba, rgb.astype(np.uint8)


def sdf_readout(cfg, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``state`` (an icon-prior ``HGPIFuNet`` state dict for ``cfg``) with
    the MLP's last layer reading only the signed distance to the body (its
    re-concatenated input column, positive inside): the occupancy is
    ``sigmoid(50 * sdf)``, so seeded random weights elsewhere give a
    body-shaped, bounded reconstruction while every layer still runs."""
    dims, res = cfg.net.mlp_dim, cfg.net.res_layers
    last = len(dims) - 2
    if last not in res:
        raise ValueError("the last MLP layer does not see the point "
                         "features (res_layers)")
    w = state[f"if_regressor.filters.{last}.weight"]
    b = state[f"if_regressor.filters.{last}.bias"]
    w = torch.zeros_like(w)
    w[0, dims[last] + cfg.net.hourglass_dim, 0] = 50.0
    return {**state, f"if_regressor.filters.{last}.weight": w,
            f"if_regressor.filters.{last}.bias": torch.zeros_like(b)}


def ve_dead_modules(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded ``netG.ve.*`` tensors of the modules the reference's volume
    encoder registers and never runs (lib/net/VE.py: ``conv_out1``,
    ``conv_out2``, and per residual stack ``bn`` and ``conv3``), as
    ``pamir.ckpt`` holds them."""
    c = cfg.net.voxel_dim
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        mods = {"conv_out1": torch.nn.Conv3d(c, c, 3, padding=1),
                "conv_out2": torch.nn.Conv3d(c, c, 3, padding=1)}
        for i in range(cfg.net.num_stack):
            mods[f"res{i}.bn"] = torch.nn.BatchNorm3d(c)
            mods[f"res{i}.conv3"] = torch.nn.Conv3d(c, c, 3, padding=1)
    return {f"netG.ve.{m}.{k}": v for m, mod in mods.items()
            for k, v in mod.state_dict().items()}


def prior_readout(cfg, state: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``state`` (an ``HGPIFuNet`` state dict for ``cfg``) with the MLP's
    last layers reading the point features, so that seeded random weights
    give a bounded reconstruction while every layer still runs:

    - icon: the signed distance to the body (:func:`sdf_readout`);
    - pamir: the volume encoder made a pass-through of the code sum (each
      stride-2 convolution's centre tap carries the sum on channel 0, the
      batch norms are the identity, the residual branches are zero), the
      occupancy ``sigmoid(50 (sum - 0.5))``: a shell around the body's
      surface where its codes sum above 0.5;
    - pifu (``use_filter`` False, so the features are the input maps): the
      layer before the last computes ``|n_x|, |n_y|, |n_z|`` of the front
      normal map (``leaky_relu`` of both signs; the NormalNet's normals are
      unit vectors on the person and 0 off it) and the query's distance
      outside the slab ``|z| < 0.1``; the occupancy ``sigmoid(50 (0.99 sum
      |n| - 0.5 - 10 slab distance))`` is the photo's silhouette extruded
      through the slab."""
    from icon_tpu_torch.models.hgpifu import mlp_first_dim
    net = cfg.net
    if net.prior_type == "icon":
        return sdf_readout(cfg, state)
    dims = net.mlp_dim
    last = len(dims) - 2
    if last not in net.res_layers or (net.prior_type != "pamir" and
                                      last - 1 not in net.res_layers):
        raise ValueError("the last MLP layers do not see the point "
                         "features (res_layers)")
    c0 = mlp_first_dim(cfg)
    out = dict(state)

    def zeroed(key):
        out[key] = torch.zeros_like(state[key])
        return out[key]

    w = zeroed(f"if_regressor.filters.{last}.weight")
    b = zeroed(f"if_regressor.filters.{last}.bias")
    if net.prior_type == "pamir":
        w[0, dims[last] + c0 - net.voxel_dim, 0] = 50.0
        b -= 25.0
        for k, v in state.items():
            if k.startswith("ve.") and k.rsplit(".", 1)[-1] in (
                    "weight", "bias", "running_mean", "running_var"):
                bn_unit = k.endswith("running_var") or (
                    v.ndim == 1 and k.endswith("weight"))
                out[k] = torch.ones_like(v) if bn_unit else \
                    torch.zeros_like(v)
        for conv, cin in (("ve.conv1", None), ("ve.conv2", 1)):
            wc = out[f"{conv}.weight"]
            c = wc.shape[-1] // 2
            wc[0, :cin, c, c, c] = 1.0
        return out
    if net.use_filter or "normal_F" not in net.in_geo_names:
        raise ValueError("the pifu readout reads the front normal map: it "
                         "needs use_filter False and normal_F in in_geo")
    nf = 3 if "image" in net.in_geo_names else 0    # normal_F's columns
    hid = last - 1
    wh = zeroed(f"if_regressor.filters.{hid}.weight")
    bh = zeroed(f"if_regressor.filters.{hid}.bias")
    for i in range(3):                              # +-n_i -> units 2i, 2i+1
        wh[2 * i, dims[hid] + nf + i, 0] = 1.0
        wh[2 * i + 1, dims[hid] + nf + i, 0] = -1.0
    wh[6, dims[hid] + c0 - 1, 0], bh[6] = 1.0, -0.1      # z - 0.1
    wh[7, dims[hid] + c0 - 1, 0], bh[7] = -1.0, -0.1     # -z - 0.1
    norm = f"if_regressor.norms.{hid}"
    if f"{norm}.running_mean" in state:             # batch norm: identity
        zeroed(f"{norm}.running_mean")
        zeroed(f"{norm}.bias")
        out[f"{norm}.running_var"] = torch.ones_like(
            state[f"{norm}.running_var"])
        out[f"{norm}.weight"] = torch.ones_like(state[f"{norm}.weight"])
    elif net.norm_mlp != "none":
        raise ValueError("the pifu readout needs a batch-norm or no-norm "
                         "MLP")
    w[0, :6, 0] = 50.0
    w[0, 6:8, 0] = -500.0
    b[0] = -25.0
    return out


def write_darknet_weights(path: str, rng: np.random.RandomState,
                          head: str = "seeded") -> None:
    """A darknet ``yolov3-tiny.weights`` (version 0.2 header, then per
    convolution [beta, gamma, mean, var] or its bias, then the weights
    ``[out, in, k, k]``) of seeded He-scaled weights and BatchNorm
    statistics. ``head="seeded"``: the two heads' convolutions too, their
    weights at 0.3 and the objectness biases lowered by 1, so that a photo
    gives tens of candidate boxes above a 0.25 score, not most anchors;
    ``head="frame"``: the heads' weights at 1/100 and their biases set so
    that every anchor scores about 0.96 for a person and spans twice the
    net input, so the best box covers the whole frame (a box from the
    detector on any photo, not the saliency fallback)."""
    from icon_tpu_torch.models.yolo import (ANCHORS, CONV_LAYERS, MASKS,
                                            N_CLASSES, NET_SIZE)
    blob = [np.array([0, 2, 0], np.int32).tobytes(),
            np.array([0], np.int64).tobytes()]
    heads = {15: MASKS[0], 22: MASKS[1]}
    for idx, cin, ch, k, bn in CONV_LAYERS:
        w = rng.randn(ch, cin, k, k) * np.sqrt(2.0 / (cin * k * k))
        if bn:
            parts = [0.1 * rng.randn(ch), 1.0 + 0.1 * rng.randn(ch),
                     0.1 * rng.randn(ch), rng.uniform(0.5, 1.5, ch)]
        else:
            bias = 0.1 * rng.randn(ch)
            if head == "seeded":
                w = w * 0.3
                bias = bias - np.tile(np.eye(5 + N_CLASSES)[4], 3)
            elif head == "frame":
                w = w * 0.01
                bias = np.full((3, 5 + N_CLASSES), -4.0)
                bias[:, 4:6] = 4.0                  # objectness, person
                bias[:, 0:2] = 0.0
                anc = ANCHORS[list(heads[idx])]
                bias[:, 2:4] = np.log(2.0 * NET_SIZE / anc)
                bias = bias.reshape(-1)
            parts = [bias]
        blob += [np.asarray(x, np.float32).tobytes() for x in parts + [w]]
    with open(path, "wb") as f:
        f.write(b"".join(blob))


def garment_polygons(body, size: int = 512) -> list:
    """A ``-seg_dir`` JSON's garments for the ``BodyModel`` ``body``'s
    rest-pose silhouette (scaled by 0.8, as :func:`synthetic_photos` draws
    it) at ``size``^2: an ``upper`` band from a fifth to the middle of its
    height and a ``lower`` band below, each a rectangle over its width, as
    ``[{"type", "coordinates": [[x0, y0, x1, y1, ...]]}]``."""
    from icon_tpu_torch.ops.raster import rasterize
    from icon_tpu_torch.render.camera import verts_to_ndc

    with torch.no_grad():
        v, _ = body()
        verts = v[0].cpu() * 0.8
        faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.int64)
        out = rasterize(verts_to_ndc(verts), faces, verts[:, :1], H=size,
                        W=size, K=min(2048, len(faces)))
    ys, xs = np.nonzero(out.mask.numpy() > 0.5)
    r0, r1, c0, c1 = (float(ys.min()), float(ys.max()), float(xs.min()),
                      float(xs.max()))
    h = r1 - r0

    def band(top, bottom):
        return [[c0, top, c1, top, c1, bottom, c0, bottom]]

    return [{"type": "upper", "coordinates": band(r0 + 0.2 * h,
                                                  r0 + 0.5 * h)},
            {"type": "lower", "coordinates": band(r0 + 0.5 * h, r1)}]


def seeded_u2net_state(lite: bool, seed: int) -> Dict[str, torch.Tensor]:
    """A U^2-Net state dict in the public checkpoint's layout: the seeded
    initialization with BatchNorm statistics, scales and biases drawn from
    ``seed``, and the fuse conv's bias at +2 so that the seeded net's
    matte stays above 0.5 (a crop the fit can use) while its side outputs
    still reach the result."""
    from icon_tpu_torch.models.u2net import build_u2net
    rng = np.random.RandomState(seed)
    state = build_u2net(lite).state_dict()
    for k, v in state.items():
        if k.endswith(("running_mean", "bn_s1.bias")):
            state[k] = torch.from_numpy(
                (0.1 * rng.randn(*v.shape)).astype(np.float32))
        elif k.endswith("running_var"):
            state[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith("bn_s1.weight"):
            state[k] = torch.from_numpy(
                (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32))
    state["outconv.bias"] = torch.full((1,), 2.0)
    return state


def seeded_pare_state(seed: int) -> Dict[str, torch.Tensor]:
    """A PARE state dict at the published geometry (HRNet-W32): the seeded
    initialization with BatchNorm statistics drawn from ``seed``, and the
    regression heads set so that the estimate stays near the rest body:
    each joint's 6D pose the identity times the mean feature plus a small
    seeded part, the shape and camera maps at 1/100 with the camera's
    bias at the mean camera (0.9, 0, 0)."""
    from icon_tpu_torch.models.pare.net import build_pare
    rng = np.random.RandomState(seed)
    net, _ = build_pare()
    state = net.state_dict()
    for k, v in state.items():
        if k.endswith("running_mean"):
            state[k] = torch.from_numpy(
                (0.1 * rng.randn(*v.shape)).astype(np.float32))
        elif k.endswith("running_var"):
            state[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    w = state["head.pose_mlp.weight"]                 # [1, 6, C, J, 1, 1]
    C = w.shape[2]
    eye = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0])
    state["head.pose_mlp.weight"] = (
        eye[None, :, None, None, None, None] / C
        + 0.002 * torch.from_numpy(rng.randn(*w.shape).astype(np.float32)))
    for name in ("shape_mlp", "cam_mlp"):
        state[f"head.{name}.weight"] = state[f"head.{name}.weight"] * 0.01
        state[f"head.{name}.bias"] = torch.zeros_like(
            state[f"head.{name}.bias"])
    state["head.cam_mlp.bias"] = torch.tensor([0.9, 0.0, 0.0])
    return state


def _seeded_batch_stats(state: Dict[str, torch.Tensor],
                        rng: np.random.RandomState) -> None:
    """BatchNorm running statistics of ``state`` drawn from ``rng``, in
    place."""
    for k, v in state.items():
        if k.endswith("running_mean"):
            state[k] = torch.from_numpy(
                (0.1 * rng.randn(*v.shape)).astype(np.float32))
        elif k.endswith("running_var"):
            state[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))


def _last_linear(state: Dict[str, torch.Tensor], module: str) -> str:
    """The key prefix of ``module``'s last ``layers.{i}`` Linear."""
    idx = max(int(k.split(".")[2]) for k in state
              if k.startswith(f"{module}.layers.") and k.endswith(".weight"))
    return f"{module}.layers.{idx}"


def pixie_rest_biases(cfg) -> Dict[str, list]:
    """Per PIXIE regressor (``Regressor_<name>``), the output of the rest
    body: each 6D pose the identity, the body camera the mean camera (0.9,
    0, 0), every other entry 0."""
    eye6 = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    return {"body": [0.9, 0.0, 0.0] + eye6 * 19,
            "head": [0.0] * (3 + cfg.n_tex + cfg.n_light),
            "head_share": [0.0] * (cfg.n_shape + cfg.n_exp) + eye6
            + [0.0] * 3,
            "hand": [0.0] * 3, "hand_share": eye6 * 16}


def seeded_pixie_state(seed: int, cfg=None) -> Dict[str, torch.Tensor]:
    """A PIXIE state dict at ``cfg``'s widths (the published ones by
    default): the seeded initialization with BatchNorm statistics drawn
    from ``seed``, and the last layer of every regressor at 1/100 with its
    bias at the rest body (:func:`pixie_rest_biases`); the moderators' last
    layers at 1/100 with
    biases (0, 0) for the head and (0, 2) for the hands, whose expert
    weight 0.88 then snaps to 1."""
    from icon_tpu_torch.models.pixie.net import PIXIE, PixieConfig
    cfg = cfg or PixieConfig()
    rng = np.random.RandomState(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        state = PIXIE(cfg).state_dict()
    _seeded_batch_stats(state, rng)
    for name, bias in pixie_rest_biases(cfg).items():
        last = _last_linear(state, f"Regressor_{name}")
        state[f"{last}.weight"] = state[f"{last}.weight"] * 0.01
        state[f"{last}.bias"] = torch.tensor(bias)
    for part, bias in (("head", [0.0, 0.0]), ("hand", [0.0, 2.0])):
        last = _last_linear(state, f"Moderator_{part}_share")
        state[f"{last}.weight"] = state[f"{last}.weight"] * 0.01
        state[f"{last}.bias"] = torch.tensor(bias)
    return state


def pixie_file_layout(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A PIXIE state dict in the published ``pixie_model.tar`` layout: one
    state dict per module, the encoders with their ImageNet ``MEAN``/``STD``
    buffers."""
    from icon_tpu_torch.models.pixie.net import IMAGENET_MEAN, IMAGENET_STD
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        module, key = k.split(".", 1)
        out.setdefault(module, {})[key] = v
    for module in ("Encoder_body", "Encoder_head", "Encoder_hand"):
        out[module]["MEAN"] = torch.tensor(IMAGENET_MEAN)[None, :, None, None]
        out[module]["STD"] = torch.tensor(IMAGENET_STD)[None, :, None, None]
    return out


def seeded_hybrik_state(seed: int) -> Dict[str, torch.Tensor]:
    """A HybrIK state dict at the published widths (ResNet-34, 29 x 64
    heatmap channels): the seeded initialization with BatchNorm statistics
    drawn from ``seed``; ``final_layer`` at 1/100 with a bias of 20 on one
    depth slice per joint (joint j at depth index 8 + 48 j / 28 of 64) and
    0 elsewhere. A 1x1 layer's bias has no spatial reach, so every joint's
    heatmap is near uniform over x and y and peaks in depth: the skeleton
    is a line through the image centre along the depth axis, z from -0.375
    to 0.375 of the unit cube (a peaked depth keeps the soft-argmax, a sum
    over 64^3 bins, well conditioned in float32). The heads at 1/100 with
    the shape at 0 (``init_shape`` 0), every twist at angle 0 (cos, sin =
    1, 0) and the camera at the mean (0.9, 0, 0, the constant the net
    adds)."""
    from icon_tpu_torch.models.hybrik.net import build_hybrik
    rng = np.random.RandomState(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net, _ = build_hybrik()
    state = net.state_dict()
    _seeded_batch_stats(state, rng)
    for name in ("final_layer", "decshape", "decphi", "deccam"):
        state[f"{name}.weight"] = state[f"{name}.weight"] * 0.01
        state[f"{name}.bias"] = torch.zeros_like(state[f"{name}.bias"])
    state["decphi.bias"] = torch.tensor([1.0, 0.0]).repeat(
        len(state["decphi.bias"]) // 2)
    n_joints = net.num_hm_joints
    depth = net.depth_dim
    for j in range(n_joints):
        d = round(depth * (0.125 + 0.75 * j / (n_joints - 1)))
        state["final_layer.bias"][j * depth + d] = 20.0
    return state


def write_demo_inputs(d: str, cfg, photo_size: int = 640, subdiv: int = 4,
                      seed: int = 0, hps_ckpt: bool = False,
                      detector: bool = False, segmenter: str = "",
                      pare_ckpt: bool = False, seg_dir: bool = False,
                      pixie_ckpt: bool = False, hybrik_ckpt: bool = False
                      ) -> Dict[str, str]:
    """The demo CLI's inputs under the directory ``d``, made from ``seed``:
    ``photos/`` with the two :func:`synthetic_photos` of the 24-joint
    synthetic SMPL body (``subdiv``) at ``photo_size``^2 (``matte.png``
    RGBA, ``scene.png`` RGB); ``cfg`` as YAML; the published checkpoints'
    layout holding HGPIFuNet's seeded init under :func:`prior_readout`, the
    geometry ``icon-filter.ckpt`` (``netG.*`` but the NormalNet; for the
    pamir prior with the volume encoder's modules that the reference
    registers and never runs: ``ve.conv_out1``, ``ve.conv_out2``,
    ``ve.res{i}.bn``, ``ve.res{i}.conv3``) and ``normal.ckpt`` (the
    NormalNet under ``netG.``); with ``hps_ckpt`` also
    ``PyMAF_model_checkpoint.pt`` of ``build_pymaf``'s seeded init at the
    published geometry (keys under ``model.``, one
    IUV-head entry the loader drops, the regressor's heads scaled by 0.05
    so that the estimate stays near the mean body).

    Under ``data/HPS`` (the ``ICON_TPU_DATA_DIR`` of ``data_dir``), in each
    file's published layout: with ``detector``, ``yolov3-tiny.weights``
    (:func:`write_darknet_weights`, heads set to box the whole frame); with
    ``segmenter`` ``"full"`` or ``"lite"``, ``u2net.pth`` or ``u2netp.pth``
    (:func:`seeded_u2net_state`); with ``pare_ckpt``,
    ``pare_data/pare_checkpoint.ckpt`` (:func:`seeded_pare_state` as a
    Lightning ``state_dict`` under ``model.``, with three entries the
    loader drops: an SMPL buffer, an ``init_pose`` buffer and the
    backbone's ``final_layer``); with ``pixie_ckpt``,
    ``pixie_data/pixie_model.tar`` (:func:`seeded_pixie_state` at the
    published widths, one state dict per module with the encoders'
    ``MEAN``/``STD``, :func:`pixie_file_layout`); with ``hybrik_ckpt``,
    ``hybrik_data/pretrained_w_cam.pth`` (:func:`seeded_hybrik_state`, with
    entries the loader drops: SMPL-layer buffers and ``init_cam``). With
    ``seg_dir``, ``segs/<photo>.json``: :func:`garment_polygons` at 512^2.

    Returns the paths by the CLI's flag names (``in_dir``, ``cfg``,
    ``ckpt``, ``normal_ckpt``, ``hps_ckpt``, ``seg_dir``), ``out_dir``
    (not created) and ``data_dir``; and the weight files written
    (``yolo``, ``u2net``, ``pare_ckpt``, ``pixie_ckpt``, ``hybrik_ckpt``)."""
    import json

    from PIL import Image
    from icon_tpu_torch.config import save_config
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24, build_pymaf
    from icon_tpu_torch.recon.frame import seeded_state

    paths = {k: os.path.join(d, v) for k, v in (
        ("in_dir", "photos"), ("cfg", "icon-filter.yaml"),
        ("ckpt", "icon-filter.ckpt"), ("normal_ckpt", "normal.ckpt"),
        ("hps_ckpt", "PyMAF_model_checkpoint.pt"), ("out_dir", "results"),
        ("data_dir", "data"))}
    os.makedirs(paths["in_dir"])
    hps_dir = os.path.join(paths["data_dir"], "HPS")
    os.makedirs(hps_dir)
    body = _synthetic_smpl24(subdiv=subdiv)
    rgba, rgb = synthetic_photos(body, photo_size, seed=seed)
    Image.fromarray(rgba).save(os.path.join(paths["in_dir"], "matte.png"))
    Image.fromarray(rgb).save(os.path.join(paths["in_dir"], "scene.png"))
    save_config(cfg, paths["cfg"])
    state = prior_readout(cfg, seeded_state(cfg, seed, normal_net=True))
    nf = "normal_filter."
    geometry = {"netG." + k: v for k, v in state.items()
                if not k.startswith(nf)}
    if cfg.net.prior_type == "pamir":
        geometry.update(ve_dead_modules(cfg, seed))
    torch.save({"state_dict": geometry}, paths["ckpt"])
    torch.save({"state_dict": {"netG." + k[len(nf):]: v
                               for k, v in state.items()
                               if k.startswith(nf)}}, paths["normal_ckpt"])
    if detector:
        paths["yolo"] = os.path.join(hps_dir, "yolov3-tiny.weights")
        write_darknet_weights(paths["yolo"], np.random.RandomState(seed + 1),
                              head="frame")
    if segmenter:
        lite = {"full": False, "lite": True}[segmenter]
        paths["u2net"] = os.path.join(hps_dir, "u2netp.pth" if lite
                                      else "u2net.pth")
        torch.save(seeded_u2net_state(lite, seed + 2), paths["u2net"])
    if pare_ckpt:
        paths["pare_ckpt"] = os.path.join(hps_dir, "pare_data",
                                          "pare_checkpoint.ckpt")
        os.makedirs(os.path.dirname(paths["pare_ckpt"]))
        pare = {"model." + k: v for k, v in seeded_pare_state(
            seed + 3).items()}
        pare.update({"model.head.smpl.v_template": torch.zeros(6890, 3),
                     "model.head.init_pose": torch.zeros(1, 144),
                     "model.backbone.final_layer.weight":
                         torch.zeros(24, 32, 1, 1)})
        torch.save({"state_dict": pare, "epoch": 0}, paths["pare_ckpt"])
    if pixie_ckpt:
        paths["pixie_ckpt"] = os.path.join(hps_dir, "pixie_data",
                                           "pixie_model.tar")
        os.makedirs(os.path.dirname(paths["pixie_ckpt"]))
        torch.save(pixie_file_layout(seeded_pixie_state(seed + 4)),
                   paths["pixie_ckpt"])
    if hybrik_ckpt:
        paths["hybrik_ckpt"] = os.path.join(hps_dir, "hybrik_data",
                                            "pretrained_w_cam.pth")
        os.makedirs(os.path.dirname(paths["hybrik_ckpt"]))
        hybrik = seeded_hybrik_state(seed + 5)
        hybrik.update({"init_cam": torch.tensor([0.9, 0.0, 0.0]),
                       "smpl.v_template": torch.zeros(6890, 3),
                       "smpl.J_regressor_h36m": torch.zeros(17, 6890),
                       "smpl.children_map": torch.zeros(24, dtype=torch.long)})
        torch.save(hybrik, paths["hybrik_ckpt"])
    if seg_dir:
        paths["seg_dir"] = os.path.join(d, "segs")
        os.makedirs(paths["seg_dir"])
        garments = garment_polygons(body)
        for name in ("matte", "scene"):
            with open(os.path.join(paths["seg_dir"], f"{name}.json"),
                      "w") as f:
                json.dump(garments, f)
    if not hps_ckpt:
        del paths["hps_ckpt"]
        return paths
    net, _ = build_pymaf()
    hps = {}
    for k, v in net.state_dict().items():
        if k.startswith("regressor.") and ".dec" in k:
            v = v * 0.05
        hps["model." + k] = v
    hps["model.iuv_predictor.predict_u.weight"] = torch.zeros(25, 256, 1, 1)
    torch.save(hps, paths["hps_ckpt"])
    return paths


# torchvision's VGG19 ``features``: conv channels, "M" a max-pool
_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def write_vgg19(path: str, seed: int = 0,
                classifier_width: int = 4096) -> str:
    """A seeded VGG19 state dict in torchvision's layout (the published
    ``vgg19-dcbb9e9d.pth``'s names and shapes): its 16 convolutions at
    ``features.{i}`` with He-scaled normal weights and small biases, and the
    three ``classifier.{0,3,6}`` layers, ``classifier_width`` wide (4096 in
    the published file; the perceptual loss never reads them). Returns
    ``path``."""
    gen = torch.Generator().manual_seed(seed)
    state, cin, i = {}, 3, 0
    for v in _VGG19_CFG:
        if v == "M":
            i += 1
            continue
        std = (2.0 / (9 * cin)) ** 0.5
        state[f"features.{i}.weight"] = std * torch.randn(
            (v, cin, 3, 3), generator=gen)
        state[f"features.{i}.bias"] = 0.01 * torch.randn((v,), generator=gen)
        cin, i = v, i + 2
    dims = (512 * 7 * 7, classifier_width, classifier_width, 1000)
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        state[f"classifier.{3 * j}.weight"] = (1.0 / a) ** 0.5 * torch.randn(
            (b, a), generator=gen)
        state[f"classifier.{3 * j}.bias"] = torch.zeros(b)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)
    return path


def write_smpl_pkl(path: str, body) -> str:
    """A SMPL release pickle (``SMPL_{GENDER}.pkl``'s keys and layouts:
    ``v_template``, ``f``, ``weights``, ``shapedirs [V, 3, B]``,
    ``posedirs [V, 3, P]``, ``J_regressor``, ``kintree_table``) of the port's
    ``BodyModel`` ``body``, for the tetrahedronizer and the tetra loader.
    Returns ``path``."""
    import pickle
    v = body.v_template.cpu().numpy()
    n_verts, n_joints = len(v), len(body.parents)
    kintree = np.stack([np.asarray(body.parents, np.int64),
                        np.arange(n_joints)])
    kintree[0, 0] = 4294967295
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({
            "v_template": v, "f": np.asarray(body.faces),
            "weights": body.lbs_weights.cpu().numpy(),
            "shapedirs": body.shapedirs.cpu().numpy(),
            "posedirs": body.posedirs.cpu().numpy().T.reshape(
                n_verts, 3, -1),
            "J_regressor": body.J_regressor.cpu().numpy(),
            "kintree_table": kintree}, f)
    return path
