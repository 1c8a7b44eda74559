"""The per-image serving frames (the JAX package's ``bench.py``, the
reference's ``ICON.test_single``) as functions.

:func:`build_frame` (``bench.py:137-226``): ``HGPIFuNet.filter`` over given
front/back normal maps; the body rasterized into per-column crossing
depths; the coarse-to-fine engine in faster mode with ``auto_budget``,
querying ``preds * 1e-6 + clothed_human_occ`` (the random-init net runs at
full compute, while the level set, and so every buffer size, is that of a
posed clothed human); lattice marching; the decode (on the card, or on
the host for a CPU frame). With
``sign="winding"`` the body features sign by the body's winding-cluster
fast winding numbers instead of the crossing columns.

:func:`build_normalnet_frame` (``bench.py:274-328`` with the demo's body
inputs, ``apps/infer.py:180-194,369-442``): the body's normal renders at
azimuth 0 and 180, the NormalNet's cloth normals, ``filter``, the per-body
prep (:func:`icon_feats`: projection, vertex visibility, cmap, crossing
columns), then the engine on bench.py's variant field, marching, pack and
decode.

:func:`build_fit_frame` (``apps/infer.py:121-292``, every prior, with
the dataset item given): the demo's per-image path after HPS. The SMPL fit
(``refine_smpl_live``, its NormalNet normals; PIFu takes the estimated body
as it is), ``filter``, the per-body prep (icon: the fitted body with its
crossing columns; PaMIR: the semantic volume of :func:`pamir_feats` through
the volume encoder; PIFu: none), the engine on the net's occupancy (or on a
field the caller derives from it, such as bench.py's variant field
:func:`variant_occ`), marching, the mesh in world coordinates,
``clean_mesh``, ``remesh``, the cloth refinement and the vertex colours. It
reuses the NormalNet frame's pieces (:func:`body_bins`, :func:`icon_feats`,
:func:`crossing_columns`). The demo CLI (``apps/infer.py``) runs it with the
CLI's own engine and marcher.

The serving frames' ``compute()`` enqueues a frame's device work, up to
the packed mesh and its copy to pinned host memory, without waiting for
the card (the engine's and the marcher's counts are taken once landed);
``frame()`` then blocks on the mesh. ``serve(n)`` is bench.py's 2-deep
loop (``bench.py:246-258``): frame i+1 is enqueued before frame i is
unpacked, and frame i's decode (on the host: the wait for its copy and,
for a CPU frame, the host decoder) runs on a worker thread while this
thread dispatches frame i+1 (:func:`serve_frames`).

On the card the serving frames replay their engine's levels and their
filter as CUDA graphs (``ReconEngine(...)(..., graph_levels=True)`` and a
:class:`~icon_tpu_torch.recon.graphs.GraphedCall` of ``filter``, the JAX
package's per-level executables and ``filter_jit``); ``Frame.graphs``
says so. A sharded frame (``mesh``), the fit frame and the CPU frames
dispatch eagerly. A graph's outputs are rewritten by its next replay: the
features and the final grid are consumed in stream order, and the stats a
frame returns are its own.

The frames run on the card unless the caller asks for the CPU. Each
``build_*`` function takes an optional device ``mesh``
(``parallel.mesh``): its engine
then pads every point buffer to the mesh's size and its queries split
along the point axis over the mesh (``shard_query``), each slice with the
network, features and body on its own device.
"""

from __future__ import annotations

import dataclasses
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from icon_tpu_torch.config import Config, NetConfig
from icon_tpu_torch.infer.refine import SmplFit, hps_body_normals, \
    refine_cloth, refine_smpl_live
from icon_tpu_torch.models.hgpifu import HGPIFuNet
from icon_tpu_torch.models.smplx.assets import SMPLX
from icon_tpu_torch.models.smplx.body import BodyModel
from icon_tpu_torch.ops.mesh import vertex_normals
from icon_tpu_torch.ops.projection import project
from icon_tpu_torch.ops.raster import vertex_visibility
from icon_tpu_torch.ops.remesh import remesh
from icon_tpu_torch.parallel.mesh import (Mesh, Replicas, shard_query,
                                          to_device)
from icon_tpu_torch.ops.sdf_fast import (build_column_bins,
                                         build_crossing_columns_blocked,
                                         build_winding_clusters,
                                         build_vertex_face_table)
from icon_tpu_torch.recon.engine import ReconEngine, reconstruction_resolutions
from icon_tpu_torch.recon.export import extract_mesh
from icon_tpu_torch.recon.graphs import GraphedCall
from icon_tpu_torch.recon.marching import AutoMarcher
from icon_tpu_torch.render.render import query_color, render_normal
from icon_tpu_torch.utils.io import clean_mesh
from icon_tpu_torch.utils.synthetic import clothed_human_occ


def bench_config(prior: str = "icon") -> Config:
    """bench.py's icon-filter config (``bench.py:77-85``): 2-stack
    hourglass, ``hourglass_dim`` 6, MLP 13-512-256-128-1 with batch norm
    (the first entry of ``mlp_dim`` becomes the 13 input features), the
    published NormalNet widths. With ``prior`` pifu or pamir, the same
    widths for that prior: the filter takes image + normals (9 channels),
    PaMIR's volume is the config's default 128^3 with 32 features, so the
    MLP is 38-512-256-128-1 (pamir) or 7-512-256-128-1 (pifu)."""
    geo = (("normal_F", 3), ("normal_B", 3))
    return Config(
        test_mode=False,
        net=NetConfig(
            mlp_dim=(256, 512, 256, 128, 1), res_layers=(2, 3, 4),
            num_stack=2, prior_type=prior, use_filter=True,
            in_geo=geo if prior == "icon" else (("image", 3),) + geo,
            in_nml=(("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)),
            smpl_feats=("sdf", "norm", "vis", "cmap"),
            norm_mlp="batch", hourglass_dim=6, smpl_dim=7))


def seeded_state(cfg: Config, seed: int, normal_net: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """HGPIFuNet's own random initialization under a fixed seed (the global
    generator is forked, so the caller's stream is untouched); with the
    NormalNet's weights when ``normal_net``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return HGPIFuNet(cfg, normal_net=normal_net).state_dict()


def _load_net(cfg: Config, state: Mapping, device, normal_net: bool):
    net = HGPIFuNet(cfg, normal_net=normal_net).to(device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v))
                         for k, v in state.items()})
    return net.eval()


@dataclasses.dataclass
class BodyBins:
    """Host tables of one body, built once per pose: the vertex -> face
    table and the compact column bins of the lattice (``bench.py:157-169``),
    on the device."""
    vf_table: torch.Tensor
    bins: torch.Tensor
    bin_meta: torch.Tensor
    tile_ids: torch.Tensor
    col_x: torch.Tensor
    col_y: torch.Tensor
    cross_meta: torch.Tensor


def asset_cmap(n_verts: int) -> Optional[np.ndarray]:
    """The installed SMPL-X cmap for a body of ``n_verts`` vertices
    (``apps/infer.py:384-396``): the asset itself for an SMPL-X body, the
    asset remapped through the nearest SMPL-X vertex of each SMPL vertex
    for an SMPL body (``smpl_verts.npy`` and ``smplx_verts.npy`` installed),
    else None."""
    reg = SMPLX()
    if not osp.exists(reg.cmap_vert_path):
        return None
    if len(reg.cmap) == n_verts:
        return reg.cmap
    if osp.exists(reg.smpl_verts_path) and \
            osp.exists(reg.smplx_verts_path) and \
            len(reg.smpl_verts) == n_verts:
        return reg.cmap_smpl_vids("smpl")
    return None


def body_bins(verts: np.ndarray, faces: np.ndarray, lattice_res: int,
              device) -> BodyBins:
    """:class:`BodyBins` of calib-space ``verts [V, 3]`` on the engine's
    ``lattice_res``^2 column lattice (y flipped like the engine's box)."""
    col_x = np.linspace(-1.0, 1.0, lattice_res, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, lattice_res, dtype=np.float32)
    cb, cm, tids = build_column_bins(verts, faces, col_x, col_y,
                                     compact=True)
    h = (lattice_res - 1) / 2.0

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return BodyBins(
        dev(build_vertex_face_table(faces, len(verts)), torch.int64),
        dev(cb), dev(cm), dev(tids), dev(col_x), dev(col_y),
        dev([-1.0, 1.0, h, -h, float(lattice_res), float(lattice_res)],
            torch.float32))


def icon_feats(verts: torch.Tensor, faces: torch.Tensor,
               calib: torch.Tensor, bins: BodyBins,
               cmap: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """The per-body prep of the demo (``apps/infer.py:_icon_feats``):
    ``verts [V, 3]`` projected to calib space by ``calib [4, 4]``, the
    vertex visibility of a 1024^2 raster, the cmap (``cmap [V, 3]`` when
    given, the demo's installed asset of :func:`asset_cmap`, else ``(v -
    vmin) / max(vmax - vmin, 1e-6)`` in calib space), the vertex normals
    (``smpl_normals``, once a body): the ``smpl_feat`` of
    ``HGPIFuNet.query`` but for ``smpl_cross_z``, which
    :func:`crossing_columns` gives."""
    v_cal = project(verts[None], calib[None])[0]
    vis = vertex_visibility(v_cal, faces)
    if cmap is None:
        vmin = torch.amin(v_cal, dim=0)
        vmax = torch.amax(v_cal, dim=0)
        cmap = (v_cal - vmin) / torch.clamp(vmax - vmin, min=1e-6)
    return {"smpl_verts": v_cal[None], "smpl_faces": faces,
            "smpl_cmap": cmap[None], "smpl_vis": vis[None],
            "smpl_normals": vertex_normals(v_cal[None], faces),
            "smpl_vf_table": bins.vf_table,
            "smpl_cross_meta": bins.cross_meta}


VOXEL_VERTS = 8000   # PaMIR's fixed vertex count (datasets.load_smpl_voxel)


def load_tetra() -> Optional[BodyModel]:
    """The installed tetrahedral SMPL (``SMPL_MALE.pkl`` with
    ``tetra_male_adult_smpl.npz``, the demo's choice), or None."""
    from icon_tpu_torch.models.smplx.tetra import load_tetra_body_model
    reg = SMPLX()
    model = osp.join(reg.model_dir, "smpl", "SMPL_MALE.pkl")
    added = osp.join(reg.tedra_dir, "tetra_male_adult_smpl.npz")
    if not (osp.exists(model) and osp.exists(added)):
        return None
    return load_tetra_body_model(model, added)[0]


def pamir_feats(verts: torch.Tensor, body: BodyModel,
                params: Mapping[str, torch.Tensor], scale: float,
                calib: torch.Tensor, tetra: Optional[BodyModel] = None
                ) -> Dict[str, torch.Tensor]:
    """PaMIR's voxel inputs for the demo (``apps/infer.py:_pamir_feats``;
    reference apps/infer.py:379-388 -> TestDataset.compute_voxel_verts):
    the ``tetra`` body (:func:`load_tetra`, on the CPU) posed with the fit's
    ``params`` (``body_pose [1, J-1, 3, 3]`` padded with identities to 23
    joints, ``global_orient``, the first 10 ``betas``, ``trans``, then
    ``scale``) and coded by its template, or without it the fitted surface
    ``verts [V, 3]`` coded by ``body``'s template; padded (or cut) to
    8,000 vertices, projected by ``calib [4, 4]`` and halved
    (PIFuDataset.py:466-481): ``voxel_verts [1, 8000, 3]`` and
    ``voxel_codes [8000, 3]`` on ``calib``'s device."""
    if tetra is not None:
        bp = params["body_pose"].detach().cpu().float()       # [1, J-1, 3, 3]
        pose = torch.eye(3).expand(1, 23, 3, 3).clone()
        nb = min(bp.shape[1], 23)   # SMPL-X HPS (pixie) has 21 body joints
        pose[:, :nb] = bp[:, :nb]
        go = params["global_orient"].detach().cpu().float().reshape(1, 9)
        betas = params["betas"].detach().cpu().float()[:, :10]
        with torch.no_grad():
            v, _ = tetra(betas=betas, global_orient=go,
                         body_pose=pose.reshape(1, 23 * 9), pose2rot=False)
        trans = params["trans"].detach().cpu().float().reshape(1, 3)
        verts = ((v[0] + trans) * scale).numpy()
        t = tetra.v_template.numpy()
    else:
        verts = verts.detach().cpu().numpy()
        t = body.v_template.cpu().numpy()[:len(verts)]
    codes = (t - t.min(0)) / np.maximum(t.max(0) - t.min(0), 1e-6)
    n = VOXEL_VERTS
    pad = max(n - len(verts), 0)
    verts = np.pad(verts[:n], ((0, pad), (0, 0)))
    codes = np.pad(codes[:n], ((0, pad), (0, 0)))
    v = torch.as_tensor(verts, dtype=torch.float32, device=calib.device)
    return {"voxel_verts": project(v[None], calib[None]) * 0.5,
            "voxel_codes": torch.as_tensor(codes.astype(np.float32),
                                           device=calib.device)}


def crossing_columns(smpl_feat: Dict[str, torch.Tensor], bins: BodyBins):
    """(cross_z, counts) of the body of ``smpl_feat`` on the lattice."""
    return build_crossing_columns_blocked(
        smpl_feat["smpl_verts"][0], smpl_feat["smpl_faces"], bins.bins,
        bins.bin_meta, bins.col_x, bins.col_y, tile_ids=bins.tile_ids)


def _marcher(res: int) -> AutoMarcher:
    # surface-bound buffers grow ~quadratically with resolution
    area_scale = max((res // 256) ** 2, 1)
    return AutoMarcher(max_cells=(1 << 18) * area_scale,
                       max_tris=(1 << 19) * area_scale,
                       max_verts=(1 << 19) * area_scale, slice_one=True,
                       codec="lattice")


def serve_frames(compute: Callable, marcher: AutoMarcher, n: int
                 ) -> List[Tuple[Dict[str, torch.Tensor], np.ndarray,
                                 np.ndarray]]:
    """bench.py's 2-deep serving loop over ``n`` frames of ``compute``
    (-> (token, mesh, stats), waiting for nothing): frame i+1 is enqueued
    before frame i is unpacked, and frame i's :meth:`AutoMarcher.decode`
    (a wait for its copy, then the mesh sliced from it or, for a CPU
    frame, the host decoder, a ctypes call that releases the GIL) runs on
    one worker thread while this thread dispatches frame i+1. Only this
    thread launches device work: a frame whose pack overflowed is
    re-packed here. Returns each frame's (stats, verts, faces) in
    order."""
    out = []

    def finish(pending):
        token, stats, decoded = pending
        verts, faces, overflow = decoded.result()
        if overflow:
            verts, faces = marcher.repack(token)
        out.append((stats, verts, faces))

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        for _ in range(n):
            token, _, stats = compute()
            if pending is not None:
                finish(pending)
            pending = (token, stats, pool.submit(marcher.decode, token))
        if pending is not None:
            finish(pending)
    return out


@dataclasses.dataclass
class Frame:
    compute: Callable          # -> (token, mesh, stats): up to the pack
    frame: Callable            # -> (stats, mesh, verts, faces): blocking
    serve: Callable            # (n) -> [(stats, verts, faces)]: 2-deep loop
    columns: Callable          # -> (cross_z, counts) of the body
    features: Callable         # -> HGPIFuNet.filter of the batch's normals
    net_occ: Callable          # (points [1,N,3], cross_z, features) -> preds
    query_fn: Callable         # the engine's field: net_occ*1e-6 + body occ
    engine: ReconEngine
    marcher: AutoMarcher
    graphs: bool = False       # engine levels and filter as CUDA graphs


def _sharded(query_fn: Callable, mesh: Optional[Mesh]) -> Callable:
    """The engine's query: ``query_fn`` itself, or split over ``mesh``."""
    return query_fn if mesh is None else shard_query(query_fn, mesh)


def build_frame(cfg: Config, state: Mapping[str, torch.Tensor],
                batch: Dict[str, np.ndarray], res: int,
                device="cuda", mesh: Optional[Mesh] = None,
                sign: str = "columns") -> Frame:
    """The serving frame for ``cfg`` with HGPIFuNet weights ``state``
    (without the NormalNet: the normals are given) on ``batch`` (numpy,
    NHWC images: ``normal_F``, ``normal_B``, ``calib``, ``smpl_verts``
    [1,V,3], ``smpl_faces``, ``smpl_cmap``, ``smpl_vis``), marching at
    ``res`` (256 -> levels 33, 65, 129, 257); the queries point-sharded
    over ``mesh`` when given. ``sign``: the body features' sign,
    ``"columns"`` (the body's crossing columns on the lattice, built once
    a frame) or ``"winding"`` (its winding clusters, built once a body on
    the host: the query's ``smpl_clusters``); the winding frame's
    ``columns()`` gives (None, None)."""
    if sign not in ("columns", "winding"):
        raise ValueError(f"sign must be 'columns' or 'winding', got "
                         f"{sign!r}")
    device = torch.device(device)
    net_on = Replicas(_load_net(cfg, state, device, normal_net=False))

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    engine = ReconEngine(reconstruction_resolutions(res), auto_budget=True,
                         auto_headroom=1.3,
                         pad_multiple=len(mesh) if mesh else 1,
                         device=device)

    verts_np = np.asarray(batch["smpl_verts"], np.float32)
    faces_np = np.asarray(batch["smpl_faces"])
    # exact sign: the body rasterized once per frame into per-column
    # crossings of the lattice; host tile binning is per body
    bins = body_bins(verts_np[0], faces_np, res + 1, device)
    smpl_feat = {
        "smpl_verts": dev(verts_np),
        "smpl_faces": dev(faces_np, torch.int64),
        "smpl_cmap": dev(batch["smpl_cmap"], torch.float32),
        "smpl_vis": dev(batch["smpl_vis"], torch.float32),
        "smpl_vf_table": bins.vf_table,
    }
    # the body's vertex normals once a frame, not once a query call
    smpl_feat["smpl_normals"] = vertex_normals(smpl_feat["smpl_verts"],
                                               smpl_feat["smpl_faces"])
    if sign == "winding":
        cf, cm = build_winding_clusters(verts_np[0], faces_np)
        smpl_feat["smpl_clusters"] = dev(cf, torch.int64)
        smpl_feat["smpl_cluster_mask"] = dev(cm)
    else:
        smpl_feat["smpl_cross_meta"] = bins.cross_meta

    def columns():
        if sign == "winding":
            return None, None
        return crossing_columns(smpl_feat, bins)

    in_t = {k: dev(batch[k], torch.float32) for k in ("normal_F", "normal_B")}
    calib = dev(batch["calib"], torch.float32)
    graphs = device.type == "cuda" and mesh is None

    def filter_eager():
        return net_on(device).filter(in_t)

    features = GraphedCall(filter_eager) if graphs else filter_eager

    def net_occ(pts, cross_z, feats):
        d = pts.device
        smpl = to_device(smpl_feat, d)
        if cross_z is not None:
            smpl["smpl_cross_z"] = cross_z
        return net_on(d).query(feats, pts, calib.to(d), smpl)[-1]

    def query_fn(pts, cross_z, feats):
        return net_occ(pts, cross_z, feats) * 1e-6 + \
            clothed_human_occ(pts)[..., None]

    engine_query = _sharded(query_fn, mesh)

    marcher = _marcher(res)

    @torch.no_grad()
    def compute():
        cross_z, _ = columns()
        occ, stats = engine(engine_query, query_args=(cross_z, features()),
                            graph_levels=graphs)
        mesh = marcher(occ, coarse_occ=stats["coarse_occ"])
        return marcher.pack(mesh), mesh, stats

    def frame():
        token, mesh, stats = compute()
        verts, faces = marcher.unpack(token)     # blocking host transfer
        return stats, mesh, verts, faces

    def serve(n: int):
        return serve_frames(compute, marcher, n)

    return Frame(compute, frame, serve, columns, features, net_occ,
                 query_fn, engine, marcher, graphs)


def spurious_occ(pts: torch.Tensor) -> torch.Tensor:
    """bench.py's band-limited spurious blobs ``[..., 1]`` (threshold
    0.72): extra coarse-level boundary cells like a trained net's noisy
    coarse levels (``bench.py:302-308``)."""
    n = (torch.sin(pts[..., 0] * 6.1 + 0.9) *
         torch.sin(pts[..., 1] * 5.3 + 2.0) *
         torch.sin(pts[..., 2] * 6.7 + 4.2))[..., None]
    return 0.8 * torch.clamp(n - 0.72, min=0.0) / 0.28


def variant_occ(preds: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """bench.py's variant field ``clip(preds * 1e-6 + clothed_human_occ +
    spurious, 0, 1)`` ``[..., 1]`` at ``pts [..., 3]``: the random-init
    net's ``preds`` run at full compute while the level set, and so every
    buffer size, is that of a posed clothed human with a trained net's noisy
    coarse levels."""
    return torch.clamp(preds * 1e-6 + clothed_human_occ(pts)[..., None] +
                       spurious_occ(pts), 0.0, 1.0)


@dataclasses.dataclass
class NormalNetFrame:
    compute: Callable    # -> (token, mesh, stats): up to the pack
    frame: Callable      # -> (stats, mesh, verts, faces): blocking
    serve: Callable      # (n) -> [(stats, verts, faces)]: 2-deep loop
    render: Callable     # -> (T_normal_F, T_normal_B) [1, H, W, 3]
    normals: Callable    # (T_F, T_B) -> (normal_F, normal_B) of NormalNet
    features: Callable   # (normal_F, normal_B) -> HGPIFuNet.filter
    body: Callable       # -> smpl_feat of icon_feats (no crossings)
    columns: Callable    # (smpl_feat) -> (cross_z, counts)
    net_occ: Callable    # (points [1,N,3], smpl_feat, features) -> preds
    query_fn: Callable   # the engine's field (bench.py's variant field)
    engine: ReconEngine
    marcher: AutoMarcher
    graphs: bool = False  # engine levels and filter as CUDA graphs


def build_normalnet_frame(cfg: Config, state: Mapping[str, torch.Tensor],
                          batch: Dict[str, np.ndarray], res: int,
                          device="cuda", mesh: Optional[Mesh] = None
                          ) -> NormalNetFrame:
    """The NormalNet serving frame for ``cfg`` with HGPIFuNet weights
    ``state`` (NormalNet included) on ``batch`` (numpy: ``image`` [1,H,W,3]
    NHWC, ``calib``, ``smpl_verts`` [1,V,3] world, ``smpl_faces``),
    marching at ``res``. Each frame renders the body's normals at ``H``^2,
    predicts the cloth normals, filters, runs the per-body prep (its host
    bins are built here, once per body), and reconstructs bench.py's
    variant field ``clip(preds * 1e-6 + clothed_human_occ + spurious, 0,
    1)``; the queries point-sharded over ``mesh`` when given."""
    device = torch.device(device)
    net = _load_net(cfg, state, device, normal_net=True)
    net_on = Replicas(net)

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    engine = ReconEngine(reconstruction_resolutions(res), auto_budget=True,
                         auto_headroom=1.3,
                         pad_multiple=len(mesh) if mesh else 1,
                         device=device)
    image = dev(batch["image"], torch.float32)
    size = image.shape[1]
    calib = dev(batch["calib"], torch.float32)
    verts = dev(batch["smpl_verts"], torch.float32)[0]
    faces = dev(batch["smpl_faces"], torch.int64)
    with torch.no_grad():
        v_cal = project(verts[None].cpu(), calib[:1].cpu())[0].numpy()
    bins = body_bins(v_cal, np.asarray(batch["smpl_faces"]),
                     engine.resolutions[-1], device)

    def render():
        return tuple(render_normal(verts, faces, size=size, azimuth=az,
                                   K=256)[0][None] for az in (0.0, 180.0))

    def normals(t_f, t_b):
        return net.predict_normals({"image": image, "T_normal_F": t_f,
                                    "T_normal_B": t_b})

    graphs = device.type == "cuda" and mesh is None

    def filter_eager(nml_f, nml_b):
        return net.filter({"image": image, "normal_F": nml_f,
                           "normal_B": nml_b})

    features = GraphedCall(filter_eager) if graphs else filter_eager

    def body():
        return icon_feats(verts, faces, calib[0], bins)

    def columns(smpl):
        return crossing_columns(smpl, bins)

    def net_occ(pts, smpl, feats):
        return net_on(pts.device).query(feats, pts, calib.to(pts.device),
                                        smpl)[-1]

    def query_fn(pts, smpl, feats):
        return variant_occ(net_occ(pts, smpl, feats), pts)

    engine_query = _sharded(query_fn, mesh)

    marcher = _marcher(res)

    @torch.no_grad()
    def compute():
        # the rasters read their face counts to the host: run them before
        # the nets are queued, so those reads do not wait for the nets
        t_f, t_b = render()
        smpl = body()
        smpl["smpl_cross_z"], _ = columns(smpl)
        feats = features(*normals(t_f, t_b))
        occ, stats = engine(engine_query, query_args=(smpl, feats),
                            graph_levels=graphs)
        mesh = marcher(occ, coarse_occ=stats["coarse_occ"])
        return marcher.pack(mesh), mesh, stats

    def frame():
        token, mesh, stats = compute()
        verts_out, faces_out = marcher.unpack(token)   # blocking transfer
        return stats, mesh, verts_out, faces_out

    def serve(n: int):
        return serve_frames(compute, marcher, n)

    return NormalNetFrame(compute, frame, serve, render, normals, features,
                          body, columns, net_occ, query_fn, engine, marcher,
                          graphs)


class FitResult(NamedTuple):
    fit: SmplFit                # the fitted body, its normals, the losses
    stats: Dict[str, torch.Tensor]   # the engine's level counts
    recon: Tuple[np.ndarray, np.ndarray]     # marched, cleaned (world)
    remeshed: Tuple[np.ndarray, np.ndarray]  # after remesh
    verts: torch.Tensor         # [V, 3] after the cloth refinement
    faces: torch.Tensor         # [F, 3] int64
    cloth_losses: List[float]
    colors: torch.Tensor        # [V, 3] in [0, 1]


@dataclasses.dataclass
class FitFrame:
    frame: Callable     # (item) -> FitResult: the whole per-image path
    fit: Callable       # (item, capture_every=0) -> SmplFit
    prep: Callable      # (image, SmplFit, calib, scale=1.0)
                        # -> (smpl_feat, features)
    net_occ: Callable   # (points [1,N,3], smpl_feat, features, calib)
                        # -> the net's occupancy [1, N, 1]
    recon: Callable     # (image, SmplFit, calib, scale=1.0)
                        # -> (verts, faces, stats)
    remesh: Callable    # (verts, faces) -> (verts, faces), host numpy
    cloth: Callable     # (verts, faces, SmplFit) -> (verts, losses)
    color: Callable     # (verts, faces, image) -> colors [V, 3]
    body: BodyModel     # on the frame's device
    net: HGPIFuNet      # eval mode, on the frame's device
    query_fn: Callable  # the engine's field: (points, smpl_feat, features,
                        # calib) -> occupancy
    engine: ReconEngine
    marcher: AutoMarcher


def build_fit_frame(cfg: Config, state: Mapping[str, torch.Tensor],
                    body: BodyModel, res: int, device="cuda",
                    loop_smpl: int = 100, loop_cloth: int = 200,
                    patience: int = 5, field: Optional[Callable] = None,
                    engine: Optional[ReconEngine] = None,
                    marcher: Optional[AutoMarcher] = None,
                    mesh: Optional[Mesh] = None) -> FitFrame:
    """The demo's fit frame for ``cfg`` with HGPIFuNet weights ``state``
    (NormalNet included) and the body model ``body`` (moved to
    ``device``), marching at ``res``, with the demo's loop lengths
    (``-loop_smpl``, ``-loop_cloth``, ``-patience``). ``frame(item)`` takes
    the dataset item as numpy: ``image [H, W, 3]`` (matted, in [-1, 1]),
    ``mask [H, W]``, ``init`` (``betas [1, n]``, ``body_pose [1, J-1, 3,
    3]``, ``global_orient [1, 1, 3, 3]``, ``trans [3]``), ``scale`` and
    ``calib [4, 4]`` (see ``utils.synthetic.synthetic_fit_item``). Every
    size follows the image's ``H``. The engine marches the net's occupancy,
    or ``field(preds, pts)`` of it when ``field`` is given (bench.py's
    :func:`variant_occ` gives random weights a human's level set).

    ``loop_smpl`` 0, and the pifu prior always, take the body as the item's
    ``init`` gives it, with the NormalNet's normals from its renders
    (``hps_body_normals``). The engine defaults to ``auto_budget`` with
    headroom 1.3 and the marcher to one sized for ``res``; the demo CLI
    passes its own (fixed budgets, ``export.make_marcher``; with
    ``-num_devices`` a ``mesh`` and an engine padded to its size, over
    which the recon's queries point-shard). The prep
    builds each prior's body features: for icon the fitted body's
    (:func:`icon_feats`, with the SMPL-X cmap asset when it is installed for
    a body of this vertex count, as the demo does: :func:`asset_cmap`, read
    once here), for pamir the volume features of :func:`pamir_feats` (the
    tetrahedral SMPL, when installed, posed with the fit's parameters and
    the item's ``scale``: :func:`load_tetra`, read once here), once a
    frame; for pifu none."""
    device = torch.device(device)
    net = _load_net(cfg, state, device, normal_net=True)
    body = body.to(device)
    body_faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.int64,
                                 device=device)
    if engine is None:
        engine = ReconEngine(reconstruction_resolutions(res),
                             auto_budget=True, auto_headroom=1.3,
                             pad_multiple=len(mesh) if mesh else 1,
                             device=device)
    net_on = Replicas(net)
    if marcher is None:
        marcher = _marcher(res)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    prior = cfg.net.prior_type
    if prior == "icon":
        # the demo's cmap choice (apps/infer.py:384-400), once per body model
        cmap = asset_cmap(body.v_template.shape[-2])
        cmap = None if cmap is None else dev(cmap)
    elif prior == "pamir":
        tetra = load_tetra()

    def fit(item, capture_every: int = 0):
        size = item["image"].shape[0]
        if loop_smpl == 0 or prior == "pifu":
            return hps_body_normals(body, body_faces, dev(item["image"]),
                                    item["init"], net.predict_normals,
                                    float(item["scale"]), size=size)
        return refine_smpl_live(
            body, body_faces, dev(item["image"]), item["init"],
            net.predict_normals, float(item["scale"]), dev(item["mask"]),
            iters=loop_smpl, size=size, patience=patience,
            capture_every=capture_every)

    def net_occ(pts, smpl, feats, calib):
        return net_on(pts.device).query(feats, pts, calib[None], smpl)[-1]

    def query_fn(pts, smpl, feats, calib):
        preds = net_occ(pts, smpl, feats, calib)
        return preds if field is None else field(preds, pts)

    engine_query = _sharded(query_fn, mesh)

    @torch.no_grad()
    def prep(image, smpl_fit: SmplFit, calib, scale: float = 1.0):
        nml_f, nml_b = smpl_fit.normals
        feats = net.filter({"image": image[None], "normal_F": nml_f[None],
                            "normal_B": nml_b[None]})
        if prior == "pamir":
            vox = pamir_feats(smpl_fit.verts, body, smpl_fit.params, scale,
                              calib, tetra)
            return {"voxel_feats": net.volume_features(
                vox["voxel_verts"], vox["voxel_codes"])}, feats
        if prior != "icon":
            return {}, feats
        v_cal = project(smpl_fit.verts[None], calib[None])[0]
        bins = body_bins(v_cal.cpu().numpy(), body.faces,
                         engine.resolutions[-1], device)
        smpl = icon_feats(smpl_fit.verts, body_faces, calib, bins, cmap)
        smpl["smpl_cross_z"], _ = crossing_columns(smpl, bins)
        return smpl, feats

    @torch.no_grad()
    def recon(image, smpl_fit: SmplFit, calib, scale: float = 1.0):
        smpl, feats = prep(image, smpl_fit, calib, scale)
        occ, stats = engine(engine_query, query_args=(smpl, feats, calib))
        verts, faces = extract_mesh(occ, marcher=marcher,
                                    coarse_occ=stats["coarse_occ"])
        verts = verts * np.array([1.0, -1.0, 1.0], np.float32)  # world y up
        if cfg.clean_mesh and len(faces):
            verts, faces = clean_mesh(verts, faces)
        return verts, np.asarray(faces, np.int64), stats

    def cloth(verts, faces, smpl_fit: SmplFit):
        nml_f, nml_b = smpl_fit.normals
        return refine_cloth(dev(verts), torch.as_tensor(faces, device=device),
                            nml_f, nml_b, iters=loop_cloth,
                            size=nml_f.shape[0])

    @torch.no_grad()
    def color(verts, faces, image):
        return query_color(verts, faces, image)

    def frame(item):
        image = dev(item["image"])
        smpl_fit = fit(item)
        verts, faces, stats = recon(image, smpl_fit, dev(item["calib"]),
                                    float(item["scale"]))
        if not len(faces):
            raise ValueError("the reconstruction is empty")
        rverts, rfaces = remesh(verts, faces)
        refined, losses = cloth(rverts, rfaces, smpl_fit)
        faces_t = torch.as_tensor(rfaces, device=device)
        return FitResult(smpl_fit, stats, (verts, faces), (rverts, rfaces),
                         refined, faces_t, losses,
                         color(refined, faces_t, image))

    return FitFrame(frame, fit, prep, net_occ, recon, remesh, cloth, color,
                    body, net, query_fn, engine, marcher)
