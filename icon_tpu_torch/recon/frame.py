"""The per-image serving frame (the JAX package's ``bench.py:137-226``, the
reference's ``ICON.test_single``) as a function.

One frame: ``HGPIFuNet.filter`` over the front/back normal maps; the body
rasterized into per-column crossing depths; the coarse-to-fine engine in
faster mode with ``auto_budget``, querying ``preds * 1e-6 +
clothed_human_occ`` (the random-init net runs at full compute, while the
level set, and so every buffer size, is that of a posed clothed human);
lattice marching; pack; host decode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from icon_tpu.config import Config, NetConfig
from icon_tpu_torch.models.hgpifu import HGPIFuNet
from icon_tpu_torch.ops.sdf_fast import (build_column_bins,
                                         build_crossing_columns_blocked,
                                         build_vertex_face_table)
from icon_tpu_torch.recon.engine import ReconEngine, reconstruction_resolutions
from icon_tpu_torch.recon.marching import AutoMarcher
from icon_tpu_torch.utils.synthetic import clothed_human_occ


def bench_config() -> Config:
    """bench.py's icon-filter config (``bench.py:77-85``): 2-stack
    hourglass, ``hourglass_dim`` 6, MLP 13-512-256-128-1 with batch norm
    (the first entry of ``mlp_dim`` becomes the 13 input features)."""
    return Config(
        test_mode=False,
        net=NetConfig(
            mlp_dim=(256, 512, 256, 128, 1), res_layers=(2, 3, 4),
            num_stack=2, prior_type="icon", use_filter=True,
            in_geo=(("normal_F", 3), ("normal_B", 3)),
            in_nml=(("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)),
            smpl_feats=("sdf", "norm", "vis", "cmap"),
            norm_mlp="batch", hourglass_dim=6, smpl_dim=7))


def seeded_state(cfg: Config, seed: int) -> Dict[str, torch.Tensor]:
    """HGPIFuNet's own random initialization under a fixed seed (the global
    generator is forked, so the caller's stream is untouched)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return HGPIFuNet(cfg).state_dict()


@dataclasses.dataclass
class Frame:
    compute: Callable          # -> (token, mesh, stats): up to the pack
    frame: Callable            # -> (stats, mesh, verts, faces): blocking
    columns: Callable          # -> (cross_z, counts) of the body
    features: Callable         # -> HGPIFuNet.filter of the batch's normals
    net_occ: Callable          # (points [1,N,3], cross_z, features) -> preds
    query_fn: Callable         # the engine's field: net_occ*1e-6 + body occ
    engine: ReconEngine
    marcher: AutoMarcher


def build_frame(cfg: Config, state: Mapping[str, torch.Tensor],
                batch: Dict[str, np.ndarray], res: int,
                device) -> Frame:
    """The serving frame for ``cfg`` with HGPIFuNet weights ``state`` on
    ``batch`` (numpy, NHWC images: ``normal_F``, ``normal_B``, ``calib``,
    ``smpl_verts`` [1,V,3], ``smpl_faces``, ``smpl_cmap``, ``smpl_vis``),
    marching at ``res`` (256 -> levels 33, 65, 129, 257)."""
    device = torch.device(device)
    net = HGPIFuNet(cfg).to(device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v))
                         for k, v in state.items()})
    net.eval()

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    resolutions = reconstruction_resolutions(res)
    engine = ReconEngine(resolutions, auto_budget=True, auto_headroom=1.3,
                         device=device)

    verts_np = np.asarray(batch["smpl_verts"], np.float32)
    faces_np = np.asarray(batch["smpl_faces"])
    smpl_feat = {
        "smpl_verts": dev(verts_np),
        "smpl_faces": dev(faces_np, torch.int64),
        "smpl_cmap": dev(batch["smpl_cmap"], torch.float32),
        "smpl_vis": dev(batch["smpl_vis"], torch.float32),
        "smpl_vf_table": dev(build_vertex_face_table(
            faces_np, verts_np.shape[1]), torch.int64),
    }
    # exact sign: the body rasterized once per frame into per-column
    # crossings of the lattice (y flipped like the engine's box); host
    # tile binning is per body
    res1 = res + 1
    col_x = np.linspace(-1.0, 1.0, res1, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, res1, dtype=np.float32)
    cb, cm, tids = build_column_bins(verts_np[0], faces_np, col_x, col_y,
                                     compact=True)
    cb, cm, tids = dev(cb), dev(cm), dev(tids)
    col_x_t, col_y_t = dev(col_x), dev(col_y)
    smpl_feat["smpl_cross_meta"] = dev(
        [-1.0, 1.0, (res1 - 1) / 2.0, (res1 - 1) / -2.0, float(res1),
         float(res1)], torch.float32)

    def columns():
        return build_crossing_columns_blocked(
            smpl_feat["smpl_verts"][0], smpl_feat["smpl_faces"], cb, cm,
            col_x_t, col_y_t, tile_ids=tids)

    in_t = {k: dev(batch[k], torch.float32) for k in ("normal_F", "normal_B")}
    calib = dev(batch["calib"], torch.float32)

    def features():
        return net.filter(in_t)

    def net_occ(pts, cross_z, feats):
        smpl = dict(smpl_feat, smpl_cross_z=cross_z)
        return net.query(feats, pts, calib, smpl)[-1]

    def query_fn(pts, cross_z, feats):
        return net_occ(pts, cross_z, feats) * 1e-6 + \
            clothed_human_occ(pts)[..., None]

    # surface-bound buffers grow ~quadratically with resolution
    area_scale = max((res // 256) ** 2, 1)
    marcher = AutoMarcher(max_cells=(1 << 18) * area_scale,
                          max_tris=(1 << 19) * area_scale,
                          max_verts=(1 << 19) * area_scale, slice_one=True)

    @torch.no_grad()
    def compute():
        cross_z, _ = columns()
        occ, stats = engine(query_fn, query_args=(cross_z, features()))
        mesh = marcher(occ, coarse_occ=stats["coarse_occ"])
        return marcher.pack(mesh), mesh, stats

    def frame():
        token, mesh, stats = compute()
        verts, faces = marcher.unpack(token)     # blocking host transfer
        return stats, mesh, verts, faces

    return Frame(compute, frame, columns, features, net_occ, query_fn,
                 engine, marcher)
