"""PyMAF, the pyramidal mesh-alignment-feedback SMPL regressor
(``icon_tpu.models.pymaf.net``; reference lib/pymaf/models/pymaf_net.py, the
demo's default ``-hps_type``, lib/dataset/TestDataset.py:90-109).

- ResNet-50 -> (s_feat 7x7x2048, g_feat 2048);
- three deconv stages (4x4, stride 2, 256 channels) build a 14/28/56
  feature pyramid;
- iteration 0 samples the first level at a 21x21 grid of points;
  iterations 1-2 project the current body's 431 downsampled vertices
  (weak perspective) and sample the next level (mesh-aligned feedback),
  each through a Conv1d MLP (256, 128, 64, 5) with an input skip;
- each iteration runs one regressor step, fc(feat + pose6d + betas + cam)
  -> residual updates of (pose 24x6D, betas 10, cam 3).

The state-dict keys are those of the published ``PyMAF_model_checkpoint.pt``
(``feature_extractor.*``, ``deconv_layers.{0,1,3,4,6,7}``,
``maf_extractor.{i}.conv{l}``, ``regressor.{i}.{fc1,fc2,decpose,decshape,
deccam}``). The SMPL forward and the vertex downsample matrix are injected:
the real assets when they are installed, synthetic stand-ins otherwise.
The grid, the downsample matrix and the mean parameters are buffers kept
out of the state dict, as the JAX package keeps them out of its variables.
Images enter NHWC; BatchNorm runs in eval mode.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.pymaf.geometry import (identity_rot6d,
                                                  rot6d_to_rotmat,
                                                  rotmat_to_angle_axis,
                                                  weak_perspective_projection)
from icon_tpu_torch.models.pymaf.resnet import ResNetBackbone
from icon_tpu_torch.models.smplx.body import BodyModel

NPOSE = 24 * 6
N_ITER = 3                       # regressor iterations, one per pyramid level
MAF_DIMS = (256, 128, 64, 5)     # the mesh-aligned extractor's Conv1d widths
GRID_SIZE = 21                   # iteration 0 samples a 21 x 21 point grid
DECONV = 256                     # channels of each deconv stage

SmplForward = Callable[[torch.Tensor, torch.Tensor],
                       Tuple[torch.Tensor, torch.Tensor]]


class MAFExtractor(nn.Module):
    """Mesh-aligned feature extraction and dimension reduction
    (maf_extractor.py:20-140): Conv1d (k=1) layers with the sampled
    features re-concatenated after the first."""

    def __init__(self):
        super().__init__()
        self.n = len(MAF_DIMS) - 1
        for i in range(self.n):
            cin = MAF_DIMS[i] if i == 0 else MAF_DIMS[i] + MAF_DIMS[0]
            self.add_module(f"conv{i}", nn.Conv1d(cin, MAF_DIMS[i + 1], 1))

    def forward(self, feat_map: torch.Tensor,
                points2d: torch.Tensor) -> torch.Tensor:
        """``feat_map [B, C, H, W]``, ``points2d [B, N, 2]`` in [-1, 1] ->
        ``[B, N * MAF_DIMS[-1]]``, flattened channel-major as the
        reference's ``reduce_dim`` (the layout of fc1's published
        weights)."""
        y = F.grid_sample(feat_map, points2d[:, :, None, :].to(
            feat_map.dtype), mode="bilinear", padding_mode="zeros",
            align_corners=True)[..., 0]                     # [B, C, N]
        skip = y
        for i in range(self.n):
            y = getattr(self, f"conv{i}")(
                y if i == 0 else torch.cat([y, skip], dim=1))
            if i != self.n - 1:
                y = F.leaky_relu(y, 0.01)
        return torch.relu(y).reshape(y.shape[0], -1)


class Regressor(nn.Module):
    """Iterative residual SMPL parameter regressor (pymaf_net.py:18-107)."""

    def __init__(self, feat_dim: int, smpl_forward: SmplForward):
        super().__init__()
        self.fc1 = nn.Linear(feat_dim + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        self.smpl_forward = smpl_forward

    def forward(self, x: torch.Tensor, init_pose: torch.Tensor,
                init_shape: torch.Tensor, init_cam: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        xc = self.fc2(self.fc1(torch.cat([x, init_pose, init_shape,
                                          init_cam], dim=1)))
        return self.finish(self.decpose(xc) + init_pose,
                           self.decshape(xc) + init_shape,
                           self.deccam(xc) + init_cam)

    def finish(self, pred_pose: torch.Tensor, pred_shape: torch.Tensor,
               pred_cam: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The body, joints and camera outputs of one parameter estimate."""
        B = pred_pose.shape[0]
        rotmat = rot6d_to_rotmat(pred_pose).reshape(B, 24, 3, 3)
        verts, joints = self.smpl_forward(pred_shape, rotmat)
        pose_aa = rotmat_to_angle_axis(rotmat.reshape(-1, 3, 3)).reshape(
            B, 72)
        return {
            "theta": torch.cat([pred_cam, pred_shape, pose_aa], dim=1),
            "verts": verts,
            "smpl_kp_3d": joints,
            "kp_2d": weak_perspective_projection(joints, pred_cam),
            "rotmat": rotmat,
            "pred_cam": pred_cam,
            "pred_shape": pred_shape,
            "pred_pose": pred_pose,
        }


class PyMAF(nn.Module):
    """The full network; ``smpl_forward(betas [B, 10], rotmats [B, 24, 3,
    3]) -> (verts, joints)`` and ``dmap [431, V]`` are injected."""

    def __init__(self, smpl_forward: SmplForward, dmap: np.ndarray,
                 mean_pose6d: Optional[np.ndarray] = None,
                 mean_shape: Optional[np.ndarray] = None,
                 mean_cam: Optional[np.ndarray] = None,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 backbone_width: int = 64):
        super().__init__()
        self.feature_extractor = ResNetBackbone(backbone_layers,
                                                backbone_width)
        seq: List[nn.Module] = []
        cin = self.feature_extractor.out_channels
        for _ in range(N_ITER):
            seq += [nn.ConvTranspose2d(cin, DECONV, 4, stride=2, padding=1,
                                       bias=False),
                    nn.BatchNorm2d(DECONV), nn.ReLU()]
            cin = DECONV
        self.deconv_layers = nn.Sequential(*seq)
        self.maf_extractor = nn.ModuleList(
            [MAFExtractor() for _ in range(N_ITER)])
        grid_feat = GRID_SIZE * GRID_SIZE * MAF_DIMS[-1]
        mesh_feat = dmap.shape[0] * MAF_DIMS[-1]
        self.regressor = nn.ModuleList(
            [Regressor(grid_feat if i == 0 else mesh_feat, smpl_forward)
             for i in range(N_ITER)])

        def const(name, value):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float32)), persistent=False)

        g = np.linspace(-1, 1, GRID_SIZE, dtype=np.float32)
        xv, yv = np.meshgrid(g, g, indexing="ij")
        const("points_grid", np.stack([xv.reshape(-1), yv.reshape(-1)], -1))
        const("dmap", dmap)
        const("mean_pose6d", identity_rot6d(24).numpy()
              if mean_pose6d is None else mean_pose6d)
        const("mean_shape", np.zeros(10) if mean_shape is None
              else mean_shape)
        const("mean_cam", np.array([0.9, 0.0, 0.0]) if mean_cam is None
              else mean_cam)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        """``x [B, 224, 224, 3]`` ImageNet-normalized -> ``{"smpl_out":
        [...]}``, one output dict per iteration after the mean-parameter
        one (the last is final)."""
        B = x.shape[0]
        s_feat, _ = self.feature_extractor(x.permute(0, 3, 1, 2))
        out = self.regressor[0].finish(
            self.mean_pose6d.expand(B, -1), self.mean_shape.expand(B, -1),
            self.mean_cam.expand(B, -1))
        outs = [out]
        for i in range(N_ITER):
            pred_cam = out["pred_cam"].detach()
            pred_shape = out["pred_shape"].detach()
            pred_pose = out["pred_pose"].detach()
            s_feat = self.deconv_layers[3 * i:3 * i + 3](s_feat)
            if i == 0:
                pts = self.points_grid.expand(B, -1, -1)
            else:
                verts_ds = torch.einsum("dv,bvc->bdc", self.dmap,
                                        out["verts"].detach())
                pts = weak_perspective_projection(verts_ds, pred_cam)
            out = self.regressor[i](self.maf_extractor[i](s_feat, pts),
                                    pred_pose, pred_shape, pred_cam)
            outs.append(out)
        return {"smpl_out": outs}


def smpl_body() -> BodyModel:
    """The installed SMPL model (``smpl/SMPL_{NEUTRAL,MALE}.{pkl,npz}``
    under the registry's model directory), else the 24-joint synthetic
    stand-in; on the CPU."""
    from icon_tpu_torch.models.smplx.assets import SMPLX
    from icon_tpu_torch.models.smplx.body import load_body_model
    model_dir = SMPLX().model_dir
    for g in ("NEUTRAL", "MALE"):
        for ext in ("pkl", "npz"):
            p = osp.join(model_dir, "smpl", f"SMPL_{g}.{ext}")
            if osp.exists(p):
                return load_body_model(p, model_type="smpl")
    return _synthetic_smpl24()


def build_pymaf(backbone_width: int = 64,
                backbone_layers: Sequence[int] = (3, 4, 6, 3)
                ) -> Tuple[PyMAF, BodyModel]:
    """PyMAF with the real assets when they are installed (the SMPL model,
    ``mesh_downsampling.npz`` and ``smpl_mean_params.npz`` under
    ``data/``), synthetic stand-ins otherwise; its random initialization
    drawn under seed 0 (the caller's generator is untouched). Returns
    (net, body model), both on the CPU."""
    from icon_tpu_torch.models.smplx.assets import data_root

    body = smpl_body()

    V = body.v_template.shape[0]
    smpl_data = osp.join(data_root(), "smpl_related", "smpl_data")
    ds_path = osp.join(smpl_data, "mesh_downsampling.npz")
    if osp.exists(ds_path):
        import scipy.sparse as sp
        data = np.load(ds_path, allow_pickle=True, encoding="latin1")
        D = data["D"]
        dmap = np.asarray(sp.coo_matrix(D[1]).todense() @
                          sp.coo_matrix(D[0]).todense(), np.float32)
    else:
        ids = np.linspace(0, V - 1, 431).astype(np.int32)
        dmap = np.zeros((431, V), np.float32)
        dmap[np.arange(431), ids] = 1.0

    mean_path = osp.join(smpl_data, "smpl_mean_params.npz")
    mp = ms = mc = None
    if osp.exists(mean_path):
        mean = np.load(mean_path)
        mp, ms, mc = (mean[k].astype(np.float32).reshape(-1)
                      for k in ("pose", "shape", "cam"))

    def smpl_forward(betas, rotmats):
        return body(betas=betas, global_orient=rotmats[:, :1].reshape(-1, 9),
                    body_pose=rotmats[:, 1:].reshape(rotmats.shape[0], -1),
                    pose2rot=False)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = PyMAF(smpl_forward, dmap, mp, ms, mc,
                    backbone_layers=tuple(backbone_layers),
                    backbone_width=backbone_width)
    return net.eval(), body


def _synthetic_smpl24(subdiv: int = 4) -> BodyModel:
    """A 24-joint SMPL-layout synthetic model (no licensed assets)."""
    from icon_tpu_torch.utils.synthetic import synthetic_body
    rng = np.random.RandomState(11)
    v, faces = synthetic_body(subdiv=subdiv)
    V, J = len(v), 24
    shapedirs = rng.randn(V, 3, 10).astype(np.float32) * 0.01
    posedirs = (rng.randn(9 * (J - 1), V * 3) * 0.0005).astype(np.float32)
    Jr = rng.rand(J, V).astype(np.float32) ** 4
    Jr /= Jr.sum(1, keepdims=True)
    w = rng.rand(V, J).astype(np.float32) ** 4
    w /= w.sum(1, keepdims=True)
    parents = [0] + [max(0, j - 1) for j in range(1, J)]
    return BodyModel(v, shapedirs, posedirs, Jr, w, faces, tuple(parents),
                     "smpl", 10)
