"""The implicit occupancy network, ICON prior (``icon_tpu.models.hgpifu``;
reference lib/net/HGPIFuNet.py).

``filter()`` turns the front/back normal maps into image features once per
frame; ``query()`` evaluates occupancy at ``[B, N, 3]`` points, the op the
recon engine calls for every point it examines. Submodules carry the
reference's names (``F_filter``, ``if_regressor``), so the state-dict keys
are those of the published checkpoints with the ``netG.`` prefix stripped.

``normal_filter`` is the NormalNet: ``filter()`` runs it when the front/back
normal maps are not given (HGPIFuNet.py:167-192). Its keys
(``normal_filter.netF.model.*``) are those of the published ``normal.ckpt``
after the reference's ``netG -> netG.normal_filter`` rename.

Ported: ``prior_type="icon"`` with the fast SMPL features
(``smpl_vf_table``) signed by the per-column crossings (``smpl_cross_z``).
Other priors and sign paths raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from icon_tpu_torch.config import Config
from icon_tpu_torch.models.hourglass import HGFilter
from icon_tpu_torch.models.mlp import MLP
from icon_tpu_torch.models.normalnet import NormalNet
from icon_tpu_torch.ops.grid_sample import grid_sample_2d
from icon_tpu_torch.ops.projection import project
from icon_tpu_torch.ops.select import feat_select


def channel_split(cfg: Config) -> List[List[int]]:
    """Indices of the F and B filter inputs in the in_geo stack
    (HGPIFuNet.py:82-92)."""
    if "image" in cfg.net.in_geo_names:
        return [[0, 1, 2, 3, 4, 5], [0, 1, 2, 6, 7, 8]]
    return [[0, 1, 2], [3, 4, 5]]


def mlp_first_dim(cfg: Config) -> int:
    """The MLP's input width for the icon prior (HGPIFuNet.py:94-121)."""
    net = cfg.net
    n_in = len(channel_split(cfg)[0])
    c0 = net.hourglass_dim if net.use_filter else n_in
    if "vis" not in net.smpl_feats:
        c0 += net.hourglass_dim if net.use_filter else n_in
    return c0 + net.smpl_dim


class HGPIFuNet(nn.Module):
    def __init__(self, cfg: Config, normal_net: bool = True):
        """``normal_net=False`` leaves out the NormalNet (two pix2pixHD
        generators) for callers that always pass the normal maps;
        ``filter()`` then needs ``normal_F`` and ``normal_B``."""
        super().__init__()
        net = cfg.net
        if net.prior_type != "icon":
            raise NotImplementedError(
                f"prior_type {net.prior_type!r} is not ported (ROADMAP "
                f"Queue A item 9)")
        if not net.use_filter:
            raise NotImplementedError(
                "use_filter=False is not ported (ROADMAP Queue A item 2)")
        self.cfg = cfg
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
                                 conv1_ksdp=tuple(net.conv1))
        self.normal_filter = NormalNet(
            net.in_nml, ngf=net.ngf, n_downsampling=net.n_downsampling,
            n_blocks=net.n_blocks) if normal_net else None

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
        if "normal_F" in in_tensor_dict and "normal_B" in in_tensor_dict:
            feats += [in_tensor_dict["normal_F"], in_tensor_dict["normal_B"]]
        else:
            feats += list(self.predict_normals(in_tensor_dict))
        return torch.cat(feats, dim=-1)

    def filter(self, in_tensor_dict: Dict[str, torch.Tensor]
               ) -> List[torch.Tensor]:
        """NHWC inputs (``normal_F`` and ``normal_B``, or what the NormalNet
        needs to predict them; ``image`` when the config's in_geo has it)
        -> ``[features [B, h, w, 2*hourglass_dim]]`` of the last stack (eval
        mode, HGPIFuNet.py:204-266)."""
        in_filter = self.get_normal(in_tensor_dict).permute(0, 3, 1, 2)
        f_in = in_filter[:, self.channels_filter[0]]
        b_in = in_filter[:, self.channels_filter[1]]
        features_f = self.F_filter(f_in)[-1]
        features_b = self.F_filter(b_in)[-1]
        return [torch.cat([features_f, features_b], dim=1)
                .permute(0, 2, 3, 1)]

    def query(self, features: Sequence[torch.Tensor], points: torch.Tensor,
              calibs: torch.Tensor, smpl_feat: Dict[str, torch.Tensor]
              ) -> List[torch.Tensor]:
        """Occupancy ``[B, N, 1]`` per feature map at world ``points
        [B, N, 3]`` (HGPIFuNet.py:268-367).

        ``smpl_feat``: smpl_verts [B,V,3], smpl_faces [F,3], smpl_cmap
        [B,V,3], smpl_vis [B,V,1], smpl_vf_table [V,deg], smpl_cross_z and
        smpl_cross_meta (``build_crossing_columns_blocked``)."""
        from icon_tpu_torch.ops.sdf_fast import cal_sdf_batch_fast
        net = self.cfg.net
        if "smpl_vf_table" not in smpl_feat or "smpl_cross_z" not in smpl_feat:
            raise NotImplementedError(
                "only the fast SMPL features signed by crossing columns are "
                "ported (smpl_vf_table + smpl_cross_z); the exact cal_sdf_batch "
                "and the ray-bin / winding signs are ROADMAP Queue A item 3")
        xyz = project(points, calibs, mode=self.cfg.projection_mode)
        xy = xyz[..., :2]
        in_cube = torch.all((xyz > -1.0) & (xyz < 1.0), dim=-1,
                            keepdim=True).to(xyz.dtype)

        sdf, norm, cmap, vis = cal_sdf_batch_fast(
            smpl_feat["smpl_verts"], smpl_feat["smpl_faces"],
            smpl_feat["smpl_cmap"], smpl_feat["smpl_vis"], xyz,
            smpl_feat["smpl_vf_table"], cross_z=smpl_feat["smpl_cross_z"],
            cross_meta=smpl_feat["smpl_cross_meta"])
        # outlier points (far from the body) get uniform features
        outlier = torch.abs(sdf) >= self.sdf_clip
        sdf = torch.where(outlier, torch.sign(sdf), sdf)
        feat_lst = [sdf]
        if "cmap" in net.smpl_feats:
            feat_lst.append(torch.where(outlier, sdf, cmap))
        if "norm" in net.smpl_feats:
            feat_lst.append(norm)
        if "vis" in net.smpl_feats:
            feat_lst.append(vis)
        smpl_feat_pts = torch.cat(feat_lst, dim=-1)

        preds_list = []
        for im_feat in features:
            if "vis" in net.smpl_feats:
                point_feat = torch.cat([
                    feat_select(grid_sample_2d(im_feat, xy),
                                smpl_feat_pts[..., -1:]),
                    smpl_feat_pts[..., :-1]], dim=-1)
            else:
                point_feat = torch.cat([grid_sample_2d(im_feat, xy),
                                        smpl_feat_pts], dim=-1)
            preds_list.append(self.if_regressor(point_feat) * in_cube)
        return preds_list
