"""HybrIK, 3D heatmaps and the hybrid analytic IK
(``icon_tpu.models.hybrik.net``; reference lib/hybrik/models/
simple3dpose.py:41-383, HybrIKBaseSMPLCam, the demo's ``-hps_type hybrik``).

simple3dpose.forward (:222-330): a ResNet-34 (``preact``), three deconvs
(``ConvTranspose2d(4, 2, 1)``, BN, ReLU), a 1x1 conv to one 3D heatmap of
``depth_dim`` x 64 x 64 per joint (channel ``j * D + d``), a soft-argmax
over (D, H, W) to uvd in [-0.5, 0.5], the camera back-projection to
root-relative xyz in units of 2.2 m, and from the pooled feature the fc
heads (``fc1``, ``fc2`` with no activation between, ``decshape`` plus the
``init_shape`` buffer, ``decphi``, ``deccam`` plus (0.9, 0, 0)); then the
IK (``models/hybrik/ik.py``) and the SMPL forward. The module names are the
published ``pretrained_w_cam.pth``'s (``models/hybrik/convert.py``).
Channel-first; BatchNorm runs in eval mode.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.hybrik.ik import hybrik_ik
from icon_tpu_torch.models.smplx.body import BodyModel

SmplForward = Callable[[torch.Tensor, torch.Tensor],
                       Tuple[torch.Tensor, torch.Tensor]]
INIT_CAM = (0.9, 0.0, 0.0)            # the reference's init_cam buffer
BONE_UNIT = 2.2                       # metres of the unit cube (xyz / 2.2)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNet34(nn.Module):
    """torchvision's BasicBlock ResNet with its key names; ``layers`` (3, 4,
    6, 3) is ResNet-34. Returns the stage-4 map ``[B, 8 width, H/32,
    W/32]``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = width
        for si, n in enumerate(layers):
            planes = width * 2 ** si
            self.add_module(f"layer{si + 1}", nn.Sequential(*[
                BasicBlock(inplanes if bi == 0 else planes, planes,
                           stride=2 if si > 0 and bi == 0 else 1,
                           downsample=si > 0 and bi == 0)
                for bi in range(n)]))
            inplanes = planes
        self.n_stages = len(layers)
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for si in range(self.n_stages):
            x = getattr(self, f"layer{si + 1}")(x)
        return x


def soft_argmax_3d(hm: torch.Tensor, num_joints: int,
                   depth_dim: int) -> torch.Tensor:
    """``[B, J * D, H, W]`` heatmap logits -> uvd ``[B, J, 3]`` in [-0.5,
    0.5]: a softmax over each joint's (D, H, W), then the expected index
    along each axis over its length (simple3dpose.py:237-268)."""
    B, _, H, W = hm.shape
    p = F.softmax(hm.reshape(B, num_joints, -1), dim=-1).reshape(
        B, num_joints, depth_dim, H, W)
    rng = [torch.arange(n, dtype=hm.dtype, device=hm.device)
           for n in (W, H, depth_dim)]
    x = (p.sum((2, 3)) * rng[0]).sum(-1) / W - 0.5
    y = (p.sum((2, 4)) * rng[1]).sum(-1) / H - 0.5
    z = (p.sum((3, 4)) * rng[2]).sum(-1) / depth_dim - 0.5
    return torch.stack([x, y, z], -1)


class HybrIK(nn.Module):
    """``x [B, 3, 256, 256]`` (ImageNet-normalized) -> ``pred_theta_mats
    [B, 24, 3, 3]``, ``pred_shape``, ``pred_phi``, ``pred_camera``,
    ``pred_uvd_jts``, ``pred_xyz_jts``, ``pred_vertices`` and
    ``pred_joints``. ``num_hm_joints`` = 29 heatmap joints (24 SMPL and
    five leaf extensions); the IK takes the 24 SMPL joints, as the JAX
    package's does."""

    def __init__(self, smpl_forward: SmplForward, rest_joints: np.ndarray,
                 parents: Sequence[int], num_hm_joints: int = 29,
                 depth_dim: int = 64,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 backbone_width: int = 64,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 focal_length: float = 1000.0, input_size: float = 256.0):
        super().__init__()
        self.smpl_forward = smpl_forward
        self.parents = tuple(int(p) for p in parents)
        self.num_hm_joints, self.depth_dim = num_hm_joints, depth_dim
        self.focal_length, self.input_size = focal_length, input_size
        self.register_buffer("rest_joints", torch.tensor(
            np.array(rest_joints), dtype=torch.float32), persistent=False)
        self.preact = ResNet34(backbone_layers, backbone_width)
        layers, c = [], self.preact.out_channels
        for f in deconv_filters:
            layers += [nn.ConvTranspose2d(c, f, 4, stride=2, padding=1,
                                          bias=False),
                       nn.BatchNorm2d(f), nn.ReLU()]
            c = f
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(c, num_hm_joints * depth_dim, 1)
        feat = self.preact.out_channels
        self.fc1 = nn.Linear(feat, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decshape = nn.Linear(1024, 10)
        self.decphi = nn.Linear(1024, (len(self.parents) - 1) * 2)
        self.deccam = nn.Linear(1024, 3)
        # the h36m mean shape in the published file
        self.register_buffer("init_shape", torch.zeros(10))
        self.register_buffer("init_cam", torch.tensor(INIT_CAM),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, J = x.shape[0], len(self.parents)
        feat = self.preact(x)
        uvd = soft_argmax_3d(self.final_layer(self.deconv_layers(feat)),
                             self.num_hm_joints, self.depth_dim)
        xc = self.fc2(self.fc1(feat.mean(dim=(2, 3))))
        pred_shape = self.decshape(xc) + self.init_shape[None]
        pred_phi = self.decphi(xc).reshape(B, J - 1, 2)
        pred_cam = self.deccam(xc) + self.init_cam[None]

        # camera back-projection (simple3dpose.py:286-302): pixels to
        # metres at the predicted depth less the camera translation, in
        # units of 2.2 m, root-relative
        cam_depth = self.focal_length / (
            self.input_size * pred_cam[:, None, :1] + 1e-9)
        z = uvd[..., 2:]
        xy = ((uvd[..., :2] * self.input_size / self.focal_length)
              * (z * BONE_UNIT + cam_depth) - pred_cam[:, None, 1:]) \
            / BONE_UNIT
        xyz = torch.cat([xy, z], -1)
        xyz = xyz - xyz[:, :1]

        rest = self.rest_joints[None].expand(B, J, 3)
        rotmats = hybrik_ik(xyz[:, :J] * BONE_UNIT, pred_phi, rest,
                            self.parents)
        verts, joints = self.smpl_forward(pred_shape, rotmats)
        return {"pred_theta_mats": rotmats, "pred_shape": pred_shape,
                "pred_phi": pred_phi, "pred_camera": pred_cam,
                "pred_uvd_jts": uvd, "pred_xyz_jts": xyz,
                "pred_vertices": verts, "pred_joints": joints}


def build_hybrik(backbone_width: int = 64,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3)
                 ) -> Tuple[HybrIK, BodyModel]:
    """HybrIK with the SMPL body when it is installed, the 24-joint
    synthetic stand-in otherwise; its random initialization drawn under
    seed 0 (the caller's generator untouched). Returns (net in eval mode,
    body model), on the CPU."""
    from icon_tpu_torch.models.pymaf.net import smpl_body

    body = smpl_body()
    rest = (body.J_regressor @ body.v_template).numpy()

    def smpl_forward(betas, rotmats):
        return body(betas=betas, global_orient=rotmats[:, :1].reshape(-1, 9),
                    body_pose=rotmats[:, 1:].reshape(rotmats.shape[0], -1),
                    pose2rot=False)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = HybrIK(smpl_forward, rest, body.parents,
                     num_hm_joints=body.num_joints + 5,
                     backbone_layers=tuple(backbone_layers),
                     backbone_width=backbone_width)
    return net.eval(), body
