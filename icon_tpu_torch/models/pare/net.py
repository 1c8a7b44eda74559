"""PARE, the part-attention SMPL regressor (``icon_tpu.models.pare.net``;
reference lib/pare/pare/models/{pare.py, head/pare_head.py}, loaded by the
demo through PARETester, lib/pare/pare/core/tester.py:28, for
``-hps_type pare``).

The published checkpoint's configuration: the HRNet-W32-conv backbone,
``use_heatmaps='part_segm'``, keypoint attention, one regression pass:

- features ``[B, 480, 56, 56]``;
- the 2D part branch: 3 x (conv3x3 256, BN, ReLU), a 1x1 conv to J + 1
  part-segmentation logits, background first (pare_head.py:809-826);
- the 3D branch: 3 x (conv3x3 256, BN, ReLU); ``smpl_final`` 1x1 -> 64;
- keypoint attention: a per-part softmax over the pixels pools both
  feature maps to per-joint vectors (layers/keypoint_attention.py:44-63);
- the pose by a per-joint locally-connected 256 -> 6D map; the shape and
  camera by ``Linear(J * 64 -> 10 / 3)`` over the channel-major flatten.

The module names are the checkpoint's (``backbone.*``, ``head.*``), so it
loads with ``load_state_dict`` (``models/pare/convert.py``). Images enter
channel-last; BatchNorm runs in eval mode.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.pare.hrnet import HRNet
from icon_tpu_torch.models.pymaf.geometry import (rot6d_to_rotmat,
                                                  weak_perspective_projection)
from icon_tpu_torch.models.smplx.body import BodyModel

SmplForward = Callable[[torch.Tensor, torch.Tensor],
                       Tuple[torch.Tensor, torch.Tensor]]


class LocallyConnected(nn.Module):
    """A per-joint linear map ``[B, J, Cin] -> [B, J, Cout]`` with no bias,
    its ``weight`` in the reference's LocallyConnected2d layout ``[1, Cout,
    Cin, J, 1, 1]`` (a 1x1 kernel over a ``[J, 1]`` grid)."""

    def __init__(self, in_ch: int, out_ch: int, num_joints: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(1, out_ch, in_ch, num_joints, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bjc,ocj->bjo", x, self.weight[0, ..., 0, 0])


def keypoint_attention(features: torch.Tensor,
                       heatmaps: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` x ``[B, J, H, W]`` -> ``[B, J, C]``: each part's
    softmax over the pixels pools the features
    (layers/keypoint_attention.py:44-63)."""
    B, C = features.shape[:2]
    J = heatmaps.shape[1]
    attn = F.softmax(heatmaps.reshape(B, J, -1), dim=-1)
    return attn @ features.reshape(B, C, -1).transpose(1, 2)


def _conv_branch(in_ch: int, filters: Sequence[int]) -> nn.Sequential:
    layers, c = [], in_ch
    for f in filters:
        layers += [nn.Conv2d(c, f, 3, padding=1, bias=False),
                   nn.BatchNorm2d(f), nn.ReLU()]
        c = f
    return nn.Sequential(*layers)


class PareHead(nn.Module):
    def __init__(self, in_ch: int = 480, num_joints: int = 24,
                 num_features_smpl: int = 64,
                 conv_filters: Sequence[int] = (256, 256, 256)):
        super().__init__()
        self.num_joints = num_joints
        self.keypoint_deconv_layers = _conv_branch(in_ch, conv_filters)
        self.smpl_deconv_layers = _conv_branch(in_ch, conv_filters)
        self.keypoint_final_layer = nn.Conv2d(conv_filters[-1],
                                              num_joints + 1, 1)
        self.smpl_final_layer = nn.Conv2d(conv_filters[-1],
                                          num_features_smpl, 1)
        self.pose_mlp = LocallyConnected(conv_filters[-1], 6, num_joints)
        self.shape_mlp = nn.Linear(num_joints * num_features_smpl, 10)
        self.cam_mlp = nn.Linear(num_joints * num_features_smpl, 3)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, J = features.shape[0], self.num_joints
        part_feats = self.keypoint_deconv_layers(features)
        smpl_feats = self.smpl_deconv_layers(features)
        segm = self.keypoint_final_layer(part_feats)
        part_attention = segm[:, 1:]
        cam_shape_feats = self.smpl_final_layer(smpl_feats)
        point_local_feat = keypoint_attention(smpl_feats, part_attention)
        cam_shape = keypoint_attention(cam_shape_feats, part_attention)
        pose6d = self.pose_mlp(point_local_feat)                # [B, J, 6]
        # the channel-major flatten of the reference's [B, 64, J]
        flat = cam_shape.transpose(1, 2).reshape(B, -1)
        rotmat = rot6d_to_rotmat(pose6d.reshape(B * J, 6)).reshape(
            B, J, 3, 3)
        return {"pred_pose": rotmat, "pred_shape": self.shape_mlp(flat),
                "pred_cam": self.cam_mlp(flat),
                "pred_segm_mask": segm.permute(0, 2, 3, 1)}


class PARE(nn.Module):
    """``x [B, H, W, 3]`` -> the head's outputs (``pred_segm_mask``
    channel-last) and the SMPL forward of the prediction:
    ``smpl_vertices``, ``smpl_joints3d`` and their weak-perspective
    ``smpl_joints2d``."""

    def __init__(self, smpl_forward: SmplForward, backbone_width: int = 32,
                 stage_modules: Sequence[int] = (1, 4, 3),
                 num_joints: int = 24):
        super().__init__()
        self.smpl_forward = smpl_forward
        self.backbone = HRNet(backbone_width, stage_modules)
        self.head = PareHead(15 * backbone_width, num_joints)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.head(self.backbone(x.permute(0, 3, 1, 2)))
        verts, joints = self.smpl_forward(out["pred_shape"],
                                          out["pred_pose"])
        out["smpl_vertices"] = verts
        out["smpl_joints3d"] = joints
        out["smpl_joints2d"] = weak_perspective_projection(joints,
                                                           out["pred_cam"])
        return out


def build_pare(backbone_width: int = 32,
               stage_modules: Sequence[int] = (1, 4, 3)
               ) -> Tuple[PARE, BodyModel]:
    """PARE with the SMPL body when it is installed, the 24-joint synthetic
    stand-in otherwise; its random initialization drawn under seed 0 (the
    caller's generator is untouched). Returns (net, body model), both on
    the CPU, the net in eval mode."""
    from icon_tpu_torch.models.pymaf.net import smpl_body

    body = smpl_body()

    def smpl_forward(betas, rotmats):
        return body(betas=betas, global_orient=rotmats[:, :1].reshape(-1, 9),
                    body_pose=rotmats[:, 1:].reshape(rotmats.shape[0], -1),
                    pose2rot=False)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = PARE(smpl_forward, backbone_width, tuple(stage_modules))
    return net.eval(), body
