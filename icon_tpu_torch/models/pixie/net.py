"""PIXIE, the SMPL-X whole-body estimator with part experts and moderators
(``icon_tpu.models.pixie.net``; reference lib/pixielib/pixie.py, the demo's
``-hps_type pixie``, built at lib/dataset/TestDataset.py:100-102).

The deployed inference graph (``PIXIE.encode`` on a body image with
threthold=True, keep_local=True, copy_and_paste=False, pixie.py:189-357):

1. the HRNet-W48 body encoder gives a 2,048-d feature; per part (head,
   left hand, right hand) an extractor Linear pulls a part-share feature
   out of it (pixie.py:239-242);
2. a coarse body estimate is decoded, and its projected joints place the
   head and hand crops (pixie.py:244-284);
3. ResNet-50 part experts encode the crops, the left hand flipped to a
   right one (pixie.py:287-295); temperature-softmax moderators mix the
   part-share and expert features, and a hand expert weight above 0.7
   snaps to 1 (pixie.py:305-315);
4. the share regressors decode SMPL-X parameters from the fused features;
   the expression and finger poses keep the experts' own estimates
   (keep_local, pixie.py:349-355);
5. 6D rotations become matrices, the jaw's Euler angles a matrix, the
   absolute head and wrist poses relative ones along the SMPL-X chain
   (SMPLX.pose_abs2rel), and the head pose is clamped to natural ranges
   (pixie.py:464-474).

The module names of :class:`PIXIE` are the published ``pixie_model.tar``'s
(``Encoder_body.encoder.*``, ``Regressor_body.layers.{i}``,
``Moderator_hand_share.temperature``, ...), so the file loads by name
(``models/pixie/convert.py``). Channel-first inside; the estimator takes
the dataset's channel-last image. BatchNorm runs in eval mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.pixie.hrnet import PixieHRNet
from icon_tpu_torch.models.pymaf.geometry import (rot6d_to_rotmat,
                                                  rotmat_to_angle_axis)
from icon_tpu_torch.models.pymaf.resnet import ResNetBackbone
from icon_tpu_torch.models.smplx.body import BodyModel

# ImageNet normalization both encoder kinds apply to their input
# (encoders.py MEAN/STD buffers)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class PixieConfig:
    """Parameter-space sizes (pixielib cfg.model.n_*) and widths; the
    defaults are the published PIXIE. ``resnet_width`` * 32 must equal
    ``feat_dim``."""

    n_shape: int = 200
    n_exp: int = 50
    n_tex: int = 50
    n_light: int = 27
    feat_dim: int = 2048
    hr_width: int = 48
    hr_stem: int = 64
    resnet_width: int = 64
    resnet_layers: Sequence[int] = (3, 4, 6, 3)
    reg_channels: Sequence[int] = (1024,)          # body/head/hand regressor
    share_channels: Sequence[int] = (1024, 1024)   # *_share regressors
    mod_channels: Sequence[int] = (1024, 1024)     # moderator hidden

    @property
    def body_layout(self) -> Dict[str, int]:
        return {"body_cam": 3, "global_pose": 6, "partbody_pose": 17 * 6,
                "neck_pose": 6}

    @property
    def head_layout(self) -> Dict[str, int]:
        return {"head_cam": 3, "tex": self.n_tex, "light": self.n_light}

    @property
    def head_share_layout(self) -> Dict[str, int]:
        return {"shape": self.n_shape, "exp": self.n_exp, "head_pose": 6,
                "jaw_pose": 3}

    @property
    def hand_layout(self) -> Dict[str, int]:
        return {"hand_cam": 3}

    @property
    def hand_share_layout(self) -> Dict[str, int]:
        return {"right_wrist_pose": 6, "right_hand_pose": 15 * 6}


def _split(vec: torch.Tensor, layout: Dict[str, int]
           ) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for k, d in layout.items():
        out[k] = vec[:, i:i + d]
        i += d
    return out


def _mlp(in_dim: int, channels: Sequence[int]) -> nn.Sequential:
    layers, c = [], in_dim
    for i, out in enumerate(channels):
        layers.append(nn.Linear(c, out))
        if i != len(channels) - 1:
            layers.append(nn.ReLU())
        c = out
    return nn.Sequential(*layers)


class TorchMLP(nn.Module):
    """The reference's ``encoders.MLP``: Linear layers with ReLU between,
    under ``layers.{Sequential index}``."""

    def __init__(self, in_dim: int, channels: Sequence[int]):
        super().__init__()
        self.layers = _mlp(in_dim, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class TempSoftmaxFusion(nn.Module):
    """A moderator (models/moderators.py:14-58): an MLP on ``[x, y]`` emits
    two logits; ``w = softmax(logits * temperature)``; the result is ``w0 x
    + w1 y``, returned with ``w``."""

    def __init__(self, in_dim: int, channels: Sequence[int]):
        super().__init__()
        self.layers = _mlp(2 * in_dim, tuple(channels) + (2,))
        self.temperature = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.layers(torch.cat([x, y], dim=-1))
        w = F.softmax(logits * self.temperature, dim=-1)
        return x * w[:, 0:1] + y * w[:, 1:2], w


class Encoder(nn.Module):
    """The reference's ``HRNEncoder`` / ``ResnetEncoder``: the ImageNet
    normalization (constants, not in the state dict), then ``encoder``,
    whose global feature it returns."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.register_buffer("MEAN", torch.tensor(IMAGENET_MEAN)[
            None, :, None, None], persistent=False)
        self.register_buffer("STD", torch.tensor(IMAGENET_STD)[
            None, :, None, None], persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.encoder((x - self.MEAN) / self.STD)
        return out[1] if isinstance(out, tuple) else out


class PIXIE(nn.Module):
    """The weights of PIXIE, under the published file's module names (hence
    the capitalized attributes). Its methods are the reference's encode
    stages, so the estimator runs the coarse, crop and fused passes."""

    def __init__(self, cfg: PixieConfig = PixieConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.Encoder_body = Encoder(PixieHRNet(c.hr_width, c.hr_stem,
                                               c.feat_dim))
        self.Encoder_head = Encoder(ResNetBackbone(tuple(c.resnet_layers),
                                                   c.resnet_width))
        self.Encoder_hand = Encoder(ResNetBackbone(tuple(c.resnet_layers),
                                                   c.resnet_width))
        reg, share = tuple(c.reg_channels), tuple(c.share_channels)
        for name, hidden, layout in (
                ("body", reg, c.body_layout), ("head", reg, c.head_layout),
                ("head_share", share, c.head_share_layout),
                ("hand", reg, c.hand_layout),
                ("hand_share", share, c.hand_share_layout)):
            self.add_module(f"Regressor_{name}", TorchMLP(
                c.feat_dim, hidden + (sum(layout.values()),)))
        for part in ("head", "left_hand", "right_hand"):
            self.add_module(f"Extractor_{part}_share",
                            TorchMLP(c.feat_dim, (c.feat_dim,)))
        for part in ("head", "hand"):
            self.add_module(f"Moderator_{part}_share", TempSoftmaxFusion(
                c.feat_dim, c.mod_channels))

    def encode_body(self, image: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``image [B, 3, H, W]`` -> (the body feature, the part-share
        features)."""
        f_body = self.Encoder_body(image)
        return f_body, {p: getattr(self, f"Extractor_{p}_share")(f_body)
                        for p in ("head", "left_hand", "right_hand")}

    def _params(self, f_body, head, left_hand, right_hand):
        """The share regressors' estimate from the body feature and the
        head and hand features."""
        c = self.cfg
        rh = _split(self.Regressor_hand_share(right_hand),
                    c.hand_share_layout)
        lh = _split(self.Regressor_hand_share(left_hand),
                    c.hand_share_layout)
        return {**_split(self.Regressor_body(f_body), c.body_layout),
                **_split(self.Regressor_head_share(head),
                         c.head_share_layout),
                "right_wrist_pose": rh["right_wrist_pose"],
                "right_hand_pose": rh["right_hand_pose"],
                "left_wrist_pose": lh["right_wrist_pose"],
                "left_hand_pose": lh["right_hand_pose"]}

    def coarse_params(self, f_body: torch.Tensor,
                      shares: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The body-only estimate (pixie.py:244-267): the share regressors
        on the extracted features."""
        return self._params(f_body, shares["head"], shares["left_hand"],
                            shares["right_hand"])

    def fused_params(self, f_body: torch.Tensor,
                     shares: Dict[str, torch.Tensor], head_image,
                     left_hand_image, right_hand_image
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
        """The estimate with the part crops (pixie.py:287-355), each ``[B,
        3, 224, 224]``; the left hand's is flipped along W here. Returns
        (params, the moderators' weights)."""
        c = self.cfg
        crops = {"head": head_image, "left_hand": left_hand_image.flip(3),
                 "right_hand": right_hand_image}
        fused, weights, local, f_head = {}, {}, {}, None
        for name, crop in crops.items():
            part = "head" if name == "head" else "hand"
            f_part = getattr(self, f"Encoder_{part}")(crop)
            if part == "head":
                f_head = f_part
            local[name] = _split(
                getattr(self, f"Regressor_{part}_share")(f_part),
                c.head_share_layout if part == "head"
                else c.hand_share_layout)
            f_out, w = getattr(self, f"Moderator_{part}_share")(
                shares[name], f_part)
            if part == "hand":
                # a confident expert wins outright (pixie.py:308-313)
                part_w = w[:, 1:2]
                part_w = torch.where(part_w > 0.7,
                                     torch.ones_like(part_w), part_w)
                f_out = shares[name] * (1.0 - part_w) + f_part * part_w
            fused[name], weights[name] = f_out, w
        params = self._params(f_body, fused["head"], fused["left_hand"],
                              fused["right_hand"])
        head = _split(self.Regressor_head(f_head), c.head_layout)
        params["tex"], params["light"] = head["tex"], head["light"]
        # keep_local: the experts' expression and finger articulation
        params["exp"] = local["head"]["exp"]
        params["right_hand_pose"] = local["right_hand"]["right_hand_pose"]
        params["left_hand_pose"] = local["left_hand"]["right_hand_pose"]
        return params, weights


# ---------------------------------------------------------------------------
# pose math (pixie.py convert_pose / decode)
# ---------------------------------------------------------------------------


def euler_to_rotmat(r: torch.Tensor) -> torch.Tensor:
    """``[B, 3]`` intrinsic-xyz Euler angles -> ``[B, 3, 3]``
    (rotation_converter.batch_euler2matrix, through the quaternion
    qx qy qz)."""
    x, y, z = r[:, 0] / 2, r[:, 1] / 2, r[:, 2] / 2
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    q = torch.stack([cx * cy * cz - sx * sy * sz,
                     cx * sy * sz + cy * cz * sx,
                     cx * cz * sy - sx * cy * sz,
                     cx * cy * sz + sx * cz * sy], -1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, qx, qy, qz = q.unbind(-1)
    return torch.stack([
        w * w + qx * qx - qy * qy - qz * qz, 2 * (qx * qy - w * qz),
        2 * (w * qy + qx * qz),
        2 * (w * qz + qx * qy), w * w - qx * qx + qy * qy - qz * qz,
        2 * (qy * qz - w * qx),
        2 * (qx * qz - w * qy), 2 * (w * qx + qy * qz),
        w * w - qx * qx - qy * qy + qz * qz], -1).reshape(-1, 3, 3)


def rotmat_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """``[B, 3, 3]`` -> intrinsic-xyz Euler ``[B, 3]``, R = Rx(a) Ry(b)
    Rz(c)."""
    b = torch.arcsin(torch.clamp(R[:, 0, 2], -1.0, 1.0))
    a = torch.arctan2(-R[:, 1, 2], R[:, 2, 2])
    c = torch.arctan2(-R[:, 0, 1], R[:, 0, 0])
    return torch.stack([a, b, c], -1)


def cont_to_rotmat(p6d: torch.Tensor) -> torch.Tensor:
    """``[B, n * 6]`` -> ``[B, n, 3, 3]`` (batch_cont2matrix)."""
    return rot6d_to_rotmat(p6d.reshape(-1, 6)).reshape(p6d.shape[0], -1,
                                                        3, 3)


# kinematic chains from a joint to the root (SMPLX.pose_abs2rel)
KIN_CHAINS = {"head": (15, 12, 9, 6, 3, 0), "neck": (12, 9, 6, 3, 0),
              "right_wrist": (21, 19, 17, 14, 9, 6, 3, 0),
              "left_wrist": (20, 18, 16, 13, 9, 6, 3, 0)}


def pose_abs2rel(global_pose: torch.Tensor, body_pose: torch.Tensor,
                 abs_joint: str) -> torch.Tensor:
    """The absolute rotation of ``abs_joint`` in ``body_pose [B, 21, 3,
    3]`` made relative to its parent chain (models/SMPLX.py:296-345);
    ``global_pose [B, 1, 3, 3]``."""
    chain = KIN_CHAINS[abs_joint]
    full = torch.cat([global_pose, body_pose], dim=1)
    rel = torch.eye(3, dtype=body_pose.dtype, device=body_pose.device
                    ).expand(body_pose.shape[0], 3, 3)
    for idx in chain[1:]:
        rel = full[:, idx] @ rel
    out = body_pose.clone()
    out[:, chain[0] - 1] = rel.transpose(1, 2) @ body_pose[:, chain[0] - 1]
    return out


def flip_rotmat(R: torch.Tensor) -> torch.Tensor:
    """A rotation mirrored across the sagittal plane (util.flip_pose:
    flat entries 1, 2, 3 and 6 negate)."""
    sign = R.new_tensor([1, -1, -1, -1, 1, 1, -1, 1, 1])
    return (R.reshape(*R.shape[:-2], 9) * sign).reshape(R.shape)


HEAD_LIMITS_DEG = (20.0, 70.0, 10.0)


def clamp_head_pose(body_pose: torch.Tensor) -> torch.Tensor:
    """check_pose (pixie.py:464-474): the head's (joint 14 of ``body_pose``)
    Euler components outside 20 / 70 / 10 degrees are zeroed."""
    eul = rotmat_to_euler_xyz(body_pose[:, 14])
    lim = eul.new_tensor(HEAD_LIMITS_DEG) * torch.pi / 180.0
    eul = torch.where(eul.abs() > lim, torch.zeros_like(eul), eul)
    out = body_pose.clone()
    out[:, 14] = euler_to_rotmat(eul)
    return out


def compose_body_pose(params: Dict[str, torch.Tensor],
                      check_pose: bool = True) -> Dict[str, torch.Tensor]:
    """The 6D and Euler parameters -> rotation matrices composed as the
    reference decodes them (pixie.py:443-474): ``global_pose [B, 1, 3, 3]``,
    ``body_pose [B, 21, 3, 3]``, ``jaw_pose [B, 1, 3, 3]`` and the hand
    poses ``[B, 15, 3, 3]``."""
    B = params["global_pose"].shape[0]
    glob = cont_to_rotmat(params["global_pose"])
    partbody = cont_to_rotmat(params["partbody_pose"])
    neck = cont_to_rotmat(params["neck_pose"])
    head = cont_to_rotmat(params["head_pose"])
    # the left side comes from the right-hand regressor on flipped crops:
    # mirror it back (pixie.py:326-334, convert_pose:454-461)
    lwrist = flip_rotmat(cont_to_rotmat(params["left_wrist_pose"]))
    rwrist = cont_to_rotmat(params["right_wrist_pose"])
    lhand = flip_rotmat(cont_to_rotmat(params["left_hand_pose"]))
    rhand = cont_to_rotmat(params["right_hand_pose"])
    jaw = euler_to_rotmat(params["jaw_pose"]).reshape(B, 1, 3, 3)
    body_pose = torch.cat([partbody[:, :11], neck, partbody[:, 11:13], head,
                           partbody[:, 13:17], lwrist, rwrist], dim=1)
    for joint in ("head", "left_wrist", "right_wrist"):
        body_pose = pose_abs2rel(glob, body_pose, joint)
    if check_pose:
        body_pose = clamp_head_pose(body_pose)
    return {"global_pose": glob, "body_pose": body_pose, "jaw_pose": jaw,
            "left_hand_pose": lhand, "right_hand_pose": rhand}


def batch_orth_proj(X: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """util.batch_orth_proj: ``X [B, N, 3]``, ``cam [B, 3]`` (scale, tx,
    ty)."""
    trans = X[:, :, :2] + cam[:, None, 1:]
    return cam[:, None, 0:1] * torch.cat([trans, X[:, :, 2:]], -1)


# ---------------------------------------------------------------------------
# part crops from the coarse body estimate (pixie.py part_from_body,
# utils/tensor_cropper; scale = (scale_min + scale_max) / 2 per part)
# ---------------------------------------------------------------------------

# the SMPL-X joints that place each part: the head by the neck, head and
# eyes; each hand by its wrist and fingers
PART_JOINTS = {
    "head": (12, 15, 22, 23, 24),
    "left_hand": (20, *range(25, 40)),
    "right_hand": (21, *range(40, 55)),
}
PART_SCALE = {"head": 2.0, "left_hand": 2.4, "right_hand": 2.4}


def crop_part_boxes(joints2d: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[B, 55, 2]`` projected joints in [-1, 1] -> per part ``[B, 3]``
    (cx, cy, half size) boxes (tensor_cropper.points2bbox: the largest
    extent times the part's scale over 2)."""
    out = {}
    for part, idx in PART_JOINTS.items():
        pts = joints2d[:, list(idx)]
        lo, hi = pts.min(dim=1).values, pts.max(dim=1).values
        half = 0.5 * (hi - lo).max(dim=-1).values * PART_SCALE[part]
        out[part] = torch.cat([0.5 * (lo + hi),
                               torch.clamp(half, min=1e-3)[:, None]], -1)
    return out


def crop_resize(image: torch.Tensor, box: torch.Tensor,
                out_size: int = 224) -> torch.Tensor:
    """``image [B, C, H, W]`` resampled bilinearly (align corners, zero
    padding) on the ``out_size``^2 grid of ``box [B, 3]`` (cx, cy, half
    size in [-1, 1]; x along W) -> ``[B, C, out, out]`` (the reference warps
    a similarity transform through grid_sample, tensor_cropper.py)."""
    from icon_tpu_torch.ops.grid_sample import grid_sample_2d
    B, C = image.shape[:2]
    lin = torch.linspace(-1.0, 1.0, out_size, device=image.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(1, -1, 2)
    pts = box[:, None, :2] + grid * box[:, None, 2:3]
    out = grid_sample_2d(image.permute(0, 2, 3, 1), pts)    # [B, o*o, C]
    return out.transpose(1, 2).reshape(B, C, out_size, out_size)


# ---------------------------------------------------------------------------
# the estimator: coarse -> crops -> fused -> SMPL-X decode
# ---------------------------------------------------------------------------


class PixieEstimator(nn.Module):
    """PIXIE end to end as the reference demo runs it (pixie.py forward:
    encode the body image, decode). The output is the dict
    lib/dataset/TestDataset.py:247-254 reads: ``vertices``, ``joints``, the
    rotation matrices ``global_pose``, ``body_pose``, ``jaw_pose``,
    ``left_hand_pose``, ``right_hand_pose``, ``shape``, ``exp``, ``cam``,
    and the part boxes ``crop_boxes``."""

    def __init__(self, cfg: Optional[PixieConfig] = None,
                 body: Optional[BodyModel] = None):
        super().__init__()
        from icon_tpu_torch.models.smplx.assets import get_smpl_model
        self.cfg = cfg or PixieConfig()
        self.net = PIXIE(self.cfg)
        self.body = body if body is not None \
            else get_smpl_model("smplx", "neutral")

    def decode_params(self, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The 6D and Euler parameters -> the SMPL-X vertices and joints
        and the rotation-matrix poses."""
        body = self.body
        rots = compose_body_pose(params)
        B = params["shape"].shape[0]

        def aa(R):
            return rotmat_to_angle_axis(R.reshape(-1, 3, 3)).reshape(B, -1)

        nexp = body.expr_dirs.shape[-1] if body.expr_dirs is not None else 0
        lhand = aa(rots["left_hand_pose"])
        rhand = aa(rots["right_hand_pose"])
        # PIXIE's SMPL-X takes the joint rotations as they are: cancel the
        # hand mean the body model adds to axis-angle hands
        if not body.flat_hand_mean:
            if body.hands_mean_l is not None:
                lhand = lhand - body.hands_mean_l[None]
            if body.hands_mean_r is not None:
                rhand = rhand - body.hands_mean_r[None]
        verts, joints = body(
            betas=params["shape"][:, :body.num_betas],
            global_orient=aa(rots["global_pose"]),
            body_pose=aa(rots["body_pose"]), jaw_pose=aa(rots["jaw_pose"]),
            expression=params["exp"][:, :nexp] if nexp else None,
            left_hand_pose=lhand, right_hand_pose=rhand)
        return {"vertices": verts, "joints": joints, **rots,
                "shape": params["shape"], "exp": params["exp"],
                "cam": params["body_cam"]}

    def forward(self, image: torch.Tensor,
                image_hd: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``image [B, H, W, 3]`` (channel-last, as the dataset gives it);
        the part crops come from ``image_hd`` when given (the reference
        crops from a 1,024^2 resize, pixie.py:277-279), else from
        ``image``."""
        x = image.permute(0, 3, 1, 2)
        f_body, shares = self.net.encode_body(x)
        coarse = self.decode_params(self.net.coarse_params(f_body, shares))
        j2d = batch_orth_proj(coarse["joints"][:, :55],
                              coarse["cam"])[..., :2]
        boxes = crop_part_boxes(j2d)
        src = x if image_hd is None else image_hd.permute(0, 3, 1, 2)
        params, _ = self.net.fused_params(
            f_body, shares, *(crop_resize(src, boxes[p]) for p in
                              ("head", "left_hand", "right_hand")))
        out = self.decode_params(params)
        out["crop_boxes"] = boxes
        return out


def build_pixie(cfg: Optional[PixieConfig] = None
                ) -> Tuple[PixieEstimator, BodyModel]:
    """The estimator with the SMPL-X body when it is installed, the
    synthetic stand-in otherwise, its random initialization drawn under
    seed 0 (the caller's generator untouched). Returns (estimator in eval
    mode, body model), on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        est = PixieEstimator(cfg)
    return est.eval(), est.body
