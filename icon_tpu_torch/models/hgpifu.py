"""The implicit occupancy network, ICON / PaMIR / PIFu in one module
(``icon_tpu.models.hgpifu``; reference lib/net/HGPIFuNet.py).

The config's ``prior_type`` selects how per-point features are assembled
(HGPIFuNet.py:82-133 channel plumbing, :268-367 query):

- ``icon``: front/back hourglass features gated by the body's visibility
  (feat_select) and the body-local features (signed distance, cmap,
  normal);
- ``pamir``: global hourglass features and trilinear samples of a 3D CNN
  (``ve``, :class:`VolumeEncoder`) over the body's semantic voxel volume;
- ``pifu`` (and any other value, as the reference's legacy ``sdf``): global
  hourglass features and the query's z.

``filter()`` turns the image stack into features once per frame;
``query()`` evaluates occupancy at ``[B, N, 3]`` points, the op the recon
engine calls for every point it examines. For PaMIR,
:meth:`HGPIFuNet.volume_features` runs the voxelization and the volume
encoder once per body, and ``query`` takes their output (or the raw voxel
vertices and codes, and runs them itself). Submodules carry the
reference's names (``F_filter``, ``if_regressor``, ``ve``), so the
state-dict keys are those of the published checkpoints with the ``netG.``
prefix stripped.

``normal_filter`` is the NormalNet: ``filter()`` runs it when the front/back
normal maps are not given (HGPIFuNet.py:167-192). Its keys
(``normal_filter.netF.model.*``) are those of the published ``normal.ckpt``
after the reference's ``netG -> netG.normal_filter`` rename.

The icon prior's body features are the fast ones when the body's
vertex-face table (``smpl_vf_table``) is given, signed by the training
samples' known signs (``smpl_query_inside``), the per-column crossings
(``smpl_cross_z``) or the ray bins (``smpl_ray_bins``); without the table
they come from the exact sweep (``ops/sdf.py:cal_sdf_batch``).

In training mode (``.train()``) the filter returns every stack, PaMIR's
volume encoder every stack's output, the MLP's BatchNorms use the batch's
statistics, and :meth:`HGPIFuNet.forward` averages the loss over the stacks
(HGPIFuNet.py:389-410).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from icon_tpu_torch.config import Config
from icon_tpu_torch.models.hourglass import HGFilter
from icon_tpu_torch.models.mlp import MLP
from icon_tpu_torch.models.normalnet import NormalNet
from icon_tpu_torch.models.volume_encoder import VolumeEncoder
from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d
from icon_tpu_torch.ops.projection import project
from icon_tpu_torch.ops.select import feat_select


def channel_split(cfg: Config) -> List[List[int]]:
    """Indices of the filter inputs in the in_geo stack: F and B for icon,
    one global stack otherwise (HGPIFuNet.py:82-92)."""
    net = cfg.net
    if net.prior_type == "icon":
        if "image" in net.in_geo_names:
            return [[0, 1, 2, 3, 4, 5], [0, 1, 2, 6, 7, 8]]
        return [[0, 1, 2], [3, 4, 5]]
    if "image" in net.in_geo_names:
        return [[0, 1, 2, 3, 4, 5, 6, 7, 8]]
    return [[0, 1, 2, 3, 4, 5]]


def mlp_first_dim(cfg: Config) -> int:
    """The MLP's input width (HGPIFuNet.py:94-121): the image features,
    then the body features (icon), the volume features (pamir) or z."""
    net = cfg.net
    n_in = len(channel_split(cfg)[0])
    c0 = net.hourglass_dim if net.use_filter else n_in
    if net.prior_type == "icon" and "vis" not in net.smpl_feats:
        c0 += net.hourglass_dim if net.use_filter else n_in
    if net.prior_type == "icon":
        return c0 + net.smpl_dim
    if net.prior_type == "pamir":
        return c0 + net.voxel_dim
    return c0 + 1


class HGPIFuNet(nn.Module):
    def __init__(self, cfg: Config, normal_net: bool = True):
        """``normal_net=False`` leaves out the NormalNet (two pix2pixHD
        generators) for callers that always pass the normal maps;
        ``filter()`` then needs ``normal_F`` and ``normal_B``."""
        super().__init__()
        net = cfg.net
        self.cfg = cfg
        self.prior_type = net.prior_type
        self.channels_filter = channel_split(cfg)
        self.sdf_clip = cfg.sdf_clip / 100.0
        mlp_channels = (mlp_first_dim(cfg),) + tuple(net.mlp_dim[1:])
        self.if_regressor = MLP(mlp_channels, res_layers=net.res_layers,
                                norm=net.norm_mlp,
                                last_sigmoid=not cfg.test_mode)
        self.F_filter = HGFilter(len(self.channels_filter[0]),
                                 num_stack=net.num_stack,
                                 depth=net.num_hourglass,
                                 hourglass_dim=net.hourglass_dim,
                                 norm=net.norm, hg_down=net.hg_down,
                                 conv1_ksdp=tuple(net.conv1)) \
            if net.use_filter else None
        self.normal_filter = NormalNet(
            net.in_nml, ngf=net.ngf, n_downsampling=net.n_downsampling,
            n_blocks=net.n_blocks) if normal_net else None
        if self.prior_type == "pamir":
            self.ve = VolumeEncoder(num_out=net.voxel_dim,
                                    num_stacks=net.num_stack)

    def predict_normals(self, in_tensor_dict: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(normal_F, normal_B) ``[B, H, W, 3]`` from the NHWC ``image``,
        ``T_normal_F`` and ``T_normal_B`` (the body's normal renders)."""
        if self.normal_filter is None:
            raise ValueError("this HGPIFuNet was built with normal_net=False")
        return self.normal_filter(in_tensor_dict)

    def get_normal(self, in_tensor_dict: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        """The NHWC in_geo stack, with the normals predicted when
        ``normal_F``/``normal_B`` are absent (HGPIFuNet.py:167-192)."""
        names = self.cfg.net.in_geo_names
        feats = []
        if "image" in names:
            feats.append(in_tensor_dict["image"])
        if "normal_F" in names and "normal_B" in names:
            if "normal_F" in in_tensor_dict and "normal_B" in in_tensor_dict:
                feats += [in_tensor_dict["normal_F"],
                          in_tensor_dict["normal_B"]]
            else:
                feats += list(self.predict_normals(in_tensor_dict))
        return torch.cat(feats, dim=-1)

    def filter(self, in_tensor_dict: Dict[str, torch.Tensor]
               ) -> List[torch.Tensor]:
        """NHWC inputs (``normal_F`` and ``normal_B``, or what the NormalNet
        needs to predict them; ``image`` when the config's in_geo has it)
        -> ``[features [B, h, w, C]]`` of the last stack in eval mode, of
        every stack in training (HGPIFuNet.py:204-266): icon's front and
        back features side by side, the other priors' one global stack;
        without the filter (``use_filter`` False) the selected input
        channels themselves."""
        in_filter = self.get_normal(in_tensor_dict).permute(0, 3, 1, 2)

        def features(chans):
            x = in_filter[:, device_constant(chans, torch.int64,
                                             in_filter.device)]
            if self.F_filter is None:
                return [x]
            stacks = self.F_filter(x)
            return stacks if self.training else stacks[-1:]

        if self.prior_type == "icon":
            feats = [torch.cat(fb, dim=1) for fb in zip(
                features(self.channels_filter[0]),
                features(self.channels_filter[1]))]
        else:
            feats = features(self.channels_filter[0])
        return [f.permute(0, 2, 3, 1) for f in feats]

    def volume_features(self, voxel_verts: torch.Tensor,
                        voxel_codes: torch.Tensor) -> List[torch.Tensor]:
        """PaMIR's per-body volume: the semantic voxelization of
        ``voxel_verts [B, V, 3]`` (calib space) with ``voxel_codes [V, 3]``
        at ``voxel_res`` (the kernels' wrapper: the card launches
        ``voxel_splat`` and ``box_smooth3d``), through the volume encoder:
        ``[features [B, D, H, W, voxel_dim]]`` of the last stack (of every
        stack in training). Differentiable in the vertices and codes, as
        the JAX package's: where they need a gradient, the backward runs
        ``box_smooth3d_bwd`` and ``voxel_splat_bwd`` (a train step
        differentiates the parameters only: the loader's inputs launch
        neither)."""
        from icon_tpu_torch.kernels.voxelize import voxelize_semantic
        vol = voxelize_semantic(voxel_verts, voxel_codes,
                                res=self.cfg.net.voxel_res)
        return [f.permute(0, 2, 3, 4, 1)
                for f in self.ve(vol.permute(0, 4, 1, 2, 3),
                                 intermediate_output=self.training)]

    def query(self, features: Sequence[torch.Tensor], points: torch.Tensor,
              calibs: torch.Tensor,
              smpl_feat: Optional[Dict[str, torch.Tensor]] = None
              ) -> List[torch.Tensor]:
        """Occupancy ``[B, N, 1]`` per feature map at world ``points
        [B, N, 3]`` (HGPIFuNet.py:268-367).

        ``smpl_feat`` by prior: icon, smpl_verts [B,V,3], smpl_faces [F,3],
        smpl_cmap [B,V,3], smpl_vis [B,V,1], and for the fast features
        smpl_vf_table [V,deg] and the sign's inputs, in this order of
        preference: smpl_query_inside [B,N] bool, smpl_cross_z and
        smpl_cross_meta (``build_crossing_columns_blocked``), smpl_ray_bins
        and smpl_ray_grid (``build_ray_bins``), smpl_clusters and
        smpl_cluster_mask (``build_winding_clusters``), or none (the
        pseudo-normal sign), and optionally smpl_normals [B,V,3], the
        bodies' ``vertex_normals`` (else computed each call); pamir,
        ``voxel_feats`` (the output of :meth:`volume_features`) or
        ``voxel_verts`` [B,V,3] (projected) and ``voxel_codes`` [V,3];
        pifu, none."""
        net = self.cfg.net
        xyz = project(points, calibs, mode=self.cfg.projection_mode)
        xy = xyz[..., :2]
        in_cube = torch.all((xyz > -1.0) & (xyz < 1.0), dim=-1,
                            keepdim=True).to(xyz.dtype)

        if self.prior_type == "icon":
            smpl_feat_pts = self._body_features(smpl_feat, xyz)
        elif self.prior_type == "pamir":
            vol_feats = smpl_feat.get("voxel_feats")
            if vol_feats is None:
                vol_feats = self.volume_features(smpl_feat["voxel_verts"],
                                                 smpl_feat["voxel_codes"])

        preds_list = []
        for i, im_feat in enumerate(features):
            point_feat = grid_sample_2d(im_feat, xy)
            if self.prior_type == "icon":
                if "vis" in net.smpl_feats:
                    point_feat = torch.cat([
                        feat_select(point_feat, smpl_feat_pts[..., -1:]),
                        smpl_feat_pts[..., :-1]], dim=-1)
                else:
                    point_feat = torch.cat([point_feat, smpl_feat_pts], -1)
            elif self.prior_type == "pamir":
                point_feat = torch.cat([point_feat, grid_sample_3d(
                    vol_feats[i], xyz)], dim=-1)
            else:
                point_feat = torch.cat([point_feat, xyz[..., 2:3]], dim=-1)
            preds_list.append(self.if_regressor(point_feat) * in_cube)
        return preds_list

    def _body_features(self, smpl_feat: Dict[str, torch.Tensor],
                       xyz: torch.Tensor) -> torch.Tensor:
        """The icon prior's body-local features ``[B, N, D]`` at the
        projected ``xyz``; far points (|sdf| >= sdf_clip) get uniform
        ones."""
        net = self.cfg.net
        if "smpl_vf_table" in smpl_feat:
            from icon_tpu_torch.ops.sdf_fast import cal_sdf_batch_fast
            sdf, norm, cmap, vis = cal_sdf_batch_fast(
                smpl_feat["smpl_verts"], smpl_feat["smpl_faces"],
                smpl_feat["smpl_cmap"], smpl_feat["smpl_vis"], xyz,
                smpl_feat["smpl_vf_table"],
                cluster_faces=smpl_feat.get("smpl_clusters"),
                cluster_mask=smpl_feat.get("smpl_cluster_mask"),
                cross_z=smpl_feat.get("smpl_cross_z"),
                cross_meta=smpl_feat.get("smpl_cross_meta"),
                ray_bins=smpl_feat.get("smpl_ray_bins"),
                ray_grid=smpl_feat.get("smpl_ray_grid"),
                known_inside=smpl_feat.get("smpl_query_inside"),
                normals=smpl_feat.get("smpl_normals"))
        else:
            from icon_tpu_torch.ops.sdf import cal_sdf_batch
            sdf, norm, cmap, vis = cal_sdf_batch(
                smpl_feat["smpl_verts"], smpl_feat["smpl_faces"],
                smpl_feat["smpl_cmap"], smpl_feat["smpl_vis"], xyz)
        outlier = torch.abs(sdf) >= self.sdf_clip
        sdf = torch.where(outlier, torch.sign(sdf), sdf)
        feat_lst = [sdf]
        if "cmap" in net.smpl_feats:
            feat_lst.append(torch.where(outlier, sdf, cmap))
        if "norm" in net.smpl_feats:
            feat_lst.append(norm)
        if "vis" in net.smpl_feats:
            feat_lst.append(vis)
        return torch.cat(feat_lst, dim=-1)

    def forward(self, in_tensor_dict: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Filter, then query the batch's ``sample`` points (HGPIFuNet.py:
        389-410): (the last stack's occupancy ``[B, N, 1]``, the loss or
        None). The loss against ``label`` is the MSE, or the smooth L1 with
        ``cfg.sdf``, averaged over the stacks."""
        features = self.filter(in_tensor_dict)
        smpl_feat = {k: v for k, v in in_tensor_dict.items()
                     if k.startswith(("smpl_", "voxel_"))}
        preds_list = self.query(features, in_tensor_dict["sample"],
                                in_tensor_dict["calib"], smpl_feat or None)
        error = None
        if "label" in in_tensor_dict:
            label = in_tensor_dict["label"]
            if self.cfg.sdf:
                err = sum(smooth_l1(p, label) for p in preds_list)
            else:
                err = sum(torch.mean((p - label) ** 2) for p in preds_list)
            error = err / len(preds_list)
        return preds_list[-1], error


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta,
                                  d - 0.5 * beta))
