"""Single-image reconstruction demo CLI (``icon_tpu.apps.infer``; reference
apps/infer.py).

Per photo of ``-in_dir``:

1. ``TestDataset`` preprocessing (the crop around the person matte) and
   the body estimate of ``-hps_type`` (pymaf, pare, pixie, hybrik or bev;
   PIXIE's is an SMPL-X body); a ``<name>_smpl.npz`` fit beside the photo
   overrides the estimate;
2. the SMPL fit against the NormalNet's cloth normals and the matte
   (``-loop_smpl`` iterations), or with ``-loop_smpl 0`` (and always for
   the pifu prior) the estimated body's normal renders at 0 and 180
   degrees through the NormalNet;
3. ``<name>_smpl.obj``, ``_smpl.npy``, ``_smpl.gif`` (none of them for the
   pifu prior) and ``_overlap.png``;
4. the occupancy reconstruction at ``-mcube_res`` (engine with fixed
   budgets, the export marcher, y flipped to world, ``clean_mesh``) with the
   config's prior: icon's body features (the SMPL-X cmap asset when
   installed), PaMIR's semantic volume (the tetrahedral SMPL when
   installed) or PIFu's z; ``<name>_recon.obj``;
5. the isotropic remesh unless ``-no_remesh``;
6. the cloth refinement (``-loop_cloth`` iterations); ``<name>_refine.obj``;
7. the vertex colours from the photo; ``<name>_recon_color.obj``;
8. with ``-seg_dir``, each garment of ``<seg_dir>/<name>.json`` cut from
   the final mesh, ``<name>_<type>.obj``;
9. with ``-export_video``, the turntable of the pre- and post-refinement
   meshes in their colours beside the photo and its predicted normals,
   ``<name>_cloth.mp4`` (360 frames at 256^2, 30 fps).

Usage (on the card):

    python -m icon_tpu_torch.apps.infer -cfg icon-filter.yaml \\
        -in_dir photos -out_dir results [-loop_smpl 100] [-loop_cloth 200]

The published ``-ckpt`` (``icon-filter.ckpt``, ``pifu.ckpt``,
``pamir.ckpt``) and ``-normal_ckpt`` (``normal.ckpt``) load by the
reference's rules (lib/dataset/mesh_util.py:187-237, apps/train.py:
201-218); a checkpoint directory (the JAX package's orbax format, which
ROADMAP "Leave these out" keeps out) raises. ``-num_devices`` n > 1
point-shards the recon's queries over the first n cards (the engine's
point buffers padded to n), as the JAX CLI does; too few cards raise the
JAX CLI's error.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_GEOMETRY_SKIP = ("normal_filter", "voxelization", "reconEngine")
# modules of the reference's volume encoder that its forward never runs
# (lib/net/VE.py), present in pamir.ckpt
_VE_DEAD = re.compile(r"ve\.(conv_out[12]|res\d+\.(bn|conv3))\.")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX CLI's flags (``icon_tpu/apps/infer.py:34-58``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-cfg", "--config_file", required=True)
    ap.add_argument("-in_dir", required=True)
    ap.add_argument("-out_dir", required=True)
    ap.add_argument("-seg_dir", default=None)
    ap.add_argument("-ckpt", default="", help="geometry checkpoint")
    ap.add_argument("-normal_ckpt", default="", help="normal-net checkpoint")
    ap.add_argument("-hps_type", default="pymaf")
    ap.add_argument("-hps_ckpt", default="")
    ap.add_argument("-loop_smpl", type=int, default=100)
    ap.add_argument("-loop_cloth", type=int, default=200)
    ap.add_argument("-patience", type=int, default=5)
    ap.add_argument("-mcube_res", type=int, default=256)
    ap.add_argument("-img_size", type=int, default=512,
                    help="working resolution for crops/renders/refinement")
    ap.add_argument("-export_video", action="store_true")
    ap.add_argument("-num_devices", type=int, default=1,
                    help="point-shard the occupancy queries over an "
                    "n-device mesh; 1 = one card")
    ap.add_argument("-no_remesh", action="store_true")
    ap.add_argument("-allow_random_hps", action="store_true",
                    help="proceed with a random-init HPS (smoke tests only; "
                    "the fits are meaningless)")
    return ap.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise for a checkpoint directory (left out: ROADMAP "Leave these
    out"), a missing checkpoint file and ``-export_video`` without cv2,
    before any work."""
    for flag, path in (("-ckpt", args.ckpt),
                       ("-normal_ckpt", args.normal_ckpt)):
        if path and osp.isdir(path):
            raise NotImplementedError(
                f"{flag} {path} is a checkpoint directory (the JAX "
                "package's orbax format), which the port leaves out "
                "(ROADMAP \"Leave these out\"); it loads the published "
                "torch files")
        if path and not osp.isfile(path):
            raise FileNotFoundError(f"{flag} {path} does not exist")
    if args.export_video:
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise ImportError("-export_video writes the mp4 with OpenCV: "
                              "cv2 is not installed") from e


def _torch_state(path: str) -> Mapping[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)


def checkpoint_state(base: Mapping[str, torch.Tensor], geometry: str = "",
                     normal: str = "") -> Dict[str, torch.Tensor]:
    """``base`` (an ``HGPIFuNet`` state dict) with the published checkpoints
    loaded over it: the geometry file's ``netG.*`` entries but the
    ``normal_filter``, ``voxelization`` and ``reconEngine`` ones and the
    volume encoder's modules that the reference never runs
    (``ve.conv_out1``, ``ve.conv_out2``, ``ve.res{i}.bn``,
    ``ve.res{i}.conv3``), and the normal file's ``netG.*`` entries renamed
    to ``netG.normal_filter.*``, each with the ``netG.`` prefix stripped.
    Raises on an entry the port has no tensor for, and on a tensor of a
    loaded scope (``F_filter``, ``if_regressor`` and PaMIR's ``ve``; the
    NormalNet's) that the file lacks; prints the count loaded."""
    loaded: Dict[str, torch.Tensor] = {}
    scopes = []
    if geometry:
        for k, v in _torch_state(geometry).items():
            if k.startswith("netG.") and \
                    not any(s in k for s in _GEOMETRY_SKIP) and \
                    not _VE_DEAD.match(k[len("netG."):]):
                loaded[k[len("netG."):]] = v
        scopes += ["F_filter.", "if_regressor.", "ve."]
    if normal:
        for k, v in _torch_state(normal).items():
            if k.startswith("netG."):
                loaded["normal_filter." + k[len("netG."):]] = v
        scopes.append("normal_filter.")
    unknown = [k for k in loaded if k not in base]
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint tensors have no place in "
                       f"the port's HGPIFuNet, e.g. {unknown[:5]}")
    missing = [k for k in base if k.startswith(tuple(scopes))
               and k not in loaded]
    if missing:
        raise KeyError(f"the checkpoints lack {len(missing)} tensors, e.g. "
                       f"{missing[:5]}")
    if loaded:
        print(f"  loaded {len(loaded)} torch tensors "
              f"({'geometry ' if geometry else ''}"
              f"{'normal' if normal else ''})", flush=True)
    return {**base, **loaded}


def fit_override(path: str, num_joints: int):
    """(init, scale) of a precomputed ``<name>_smpl.npz`` fit (axis-angle
    ``body_pose``/``global_orient``, ``betas``, ``transl``, ``scale``)."""
    from icon_tpu_torch.models.smplx.lbs import batch_rodrigues

    fit = np.load(path)

    def rotmats(aa):
        return batch_rodrigues(torch.from_numpy(
            np.asarray(aa, np.float32).reshape(-1, 3))).numpy()

    init = {"betas": fit["betas"].reshape(1, -1).astype(np.float32),
            "body_pose": rotmats(fit["body_pose"]).reshape(
                1, -1, 3, 3)[:, :num_joints - 1],
            "global_orient": rotmats(fit["global_orient"]).reshape(
                1, 1, 3, 3),
            "trans": fit["transl"].reshape(3).astype(np.float32)}
    return init, float(fit["scale"]) if "scale" in fit else 1.0


def export_overlap(path: str, image: np.ndarray, nml_f: np.ndarray,
                   mask: np.ndarray) -> None:
    """[input | input with the predicted cloth normal over the mask]
    (reference blend_rgb_norm and ``_overlap.png``, apps/infer.py:326-348)."""
    from PIL import Image

    def to_u8(x):
        return (np.clip(x * 0.5 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)

    img = to_u8(image)
    norm = to_u8(nml_f)
    m = (np.asarray(mask) > 0.5).astype(np.uint8)[..., None]
    blend = img * (1 - m) + norm * m
    Image.fromarray(np.concatenate([img, blend], axis=1)).save(path)


def export_turntable_video(path: str, image: np.ndarray, nml_f: np.ndarray,
                           meshes, faces: np.ndarray, size: int = 256,
                           n_frames: int = 360, fps: int = 30,
                           device="cuda") -> None:
    """The coloured meshes turning a full circle (reference
    get_rendered_video, lib/common/render.py:327-374): each frame is the
    photo and the predicted front normal (resized by PIL to ``size``^2),
    then each mesh of ``meshes`` (``[(verts, vertex colours), ...]``, numpy,
    sharing ``faces``) rotated about y on the host in float32 as the JAX
    CLI does, rendered on ``device`` over grey (K=128); ``n_frames`` frames
    at ``fps`` to ``path`` (mp4)."""
    import math

    from PIL import Image

    from icon_tpu_torch.render.render import make_turntable_renderer
    from icon_tpu_torch.utils.io import save_video

    device = torch.device(device)
    panels = []
    for img in (image, nml_f):
        p = np.clip(np.asarray(img) * 0.5 + 0.5, 0.0, 1.0)
        p8 = (p * 255).astype(np.uint8)
        panels.append(np.asarray(Image.fromarray(p8).resize((size, size))))
    panels = torch.from_numpy(np.concatenate(panels, axis=1)).to(device)

    faces_t = torch.as_tensor(np.asarray(faces), dtype=torch.int64,
                              device=device)
    renderers = [make_turntable_renderer(
        faces_t, torch.as_tensor(np.asarray(c), dtype=torch.float32,
                                 device=device), size=size, K=128)
        for _, c in meshes]
    frames = torch.empty((n_frames, size, size * (2 + len(meshes)), 3),
                         dtype=torch.uint8, device=device)
    for i in range(n_frames):
        a = math.radians(i * 360.0 / n_frames)
        c_, s_ = math.cos(a), math.sin(a)
        rot = np.array([[c_, 0.0, -s_], [0.0, 1.0, 0.0], [s_, 0.0, c_]],
                       np.float32)
        row = [panels]
        for (v, _), render in zip(meshes, renderers):
            v_rot = np.asarray(v, np.float32) @ rot.T
            rgb = render(torch.from_numpy(v_rot).to(device)).clamp(0.0, 1.0)
            row.append((rgb * 255).to(torch.uint8))
        frames[i] = torch.cat(row, dim=1)
    save_video(path, frames.cpu().numpy(), fps=fps)
    print(f"  video: {path} ({n_frames} frames)", flush=True)


def extract_garments(seg_dir: str, out_dir: str, name: str,
                     verts: np.ndarray, faces: np.ndarray
                     ) -> Dict[str, Tuple[int, int]]:
    """Each garment of ``<seg_dir>/<name>.json`` cut from the mesh by its
    polygons (``ops/cloth_extraction.py:extract_cloth``) and written as
    ``<out_dir>/<name>_<type>.obj``; returns {type: (verts, faces)} of the
    written ones (none without the JSON)."""
    import json

    from icon_tpu_torch.ops.cloth_extraction import extract_cloth
    from icon_tpu_torch.utils.io import save_obj

    seg_path = osp.join(seg_dir, f"{name}.json")
    if not osp.exists(seg_path):
        return {}
    with open(seg_path) as f:
        segmentations = json.load(f)
    written = {}
    for seg in segmentations:
        garment = extract_cloth(verts, faces, seg)
        if garment is None:
            continue
        g_verts, g_faces = garment
        kind = seg.get("type", "garment")
        save_obj(osp.join(out_dir, f"{name}_{kind}.obj"), g_verts, g_faces)
        written[kind] = (len(g_verts), len(g_faces))
        print(f"  garment: {seg.get('type')} -> {len(g_verts)} verts",
              flush=True)
    return written


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         keep_meshes: bool = False) -> List[Dict[str, object]]:
    """Run the demo over ``argv`` (``sys.argv[1:]`` when None) on
    ``device`` (the card unless the caller asks for the CPU). Returns one
    record per photo: its stage times in seconds (each ended by a device
    synchronize), the loop lengths and losses, the mesh sizes; with
    ``keep_meshes`` also ``meshes``: the fitted body, the recon and the
    final mesh as numpy (verts, faces), as the fit, cloth and colour stages
    take them, and ``turntable``: the meshes and colours of the video."""
    from icon_tpu_torch.config import load_config
    from icon_tpu_torch.data.render_dataset import make_calib
    from icon_tpu_torch.data.test_dataset import TestDataset
    from icon_tpu_torch.recon.engine import (ReconEngine,
                                             reconstruction_resolutions)
    from icon_tpu_torch.recon.export import make_marcher
    from icon_tpu_torch.recon.frame import build_fit_frame, seeded_state
    from icon_tpu_torch.utils.io import save_gif, save_obj

    args = parse_args(argv)
    cfg = load_config(args.config_file).replace(test_mode=False,
                                                mcube_res=args.mcube_res)
    refuse_unported(args)
    fits = cfg.net.prior_type != "pifu"
    device = torch.device(device)
    mesh = None
    if args.num_devices > 1:
        from icon_tpu_torch.parallel.mesh import (GROUP_NORM_WARNING,
                                                  make_mesh)
        mesh = make_mesh(args.num_devices, device)
        print(f"[infer] point-sharding recon over {len(mesh)} devices",
              flush=True)
        if cfg.net.norm_mlp == "group":
            print(f"[infer] {GROUP_NORM_WARNING}", flush=True)
    dataset = TestDataset(args.in_dir, hps_type=args.hps_type,
                          hps_ckpt=args.hps_ckpt, icon_size=args.img_size,
                          allow_random_hps=args.allow_random_hps,
                          device=device)
    if len(dataset) == 0:
        raise SystemExit(f"no images in {args.in_dir}")
    os.makedirs(args.out_dir, exist_ok=True)
    state = checkpoint_state(seeded_state(cfg, 0, normal_net=True),
                             args.ckpt, args.normal_ckpt)
    calib8 = make_calib(0.0)
    calib = torch.as_tensor(calib8[4:8] @ calib8[:4], device=device)
    flip_y = np.array([1, -1, 1], np.float32)

    def out_path(name, suffix):
        return osp.join(args.out_dir, f"{name}{suffix}")

    frame = None
    records = []
    for idx in range(len(dataset)):
        stage: Dict[str, float] = {"writes": 0.0}
        clock = [time.perf_counter()]

        def lap(name):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            stage[name] = stage.get(name, 0.0) + now - clock[0]
            clock[0] = now

        name, processed = dataset.preprocess(idx, stages=stage)
        print(f"[infer] {name}", flush=True)
        lap("preprocess")
        stage["preprocess"] -= stage.get("detect", 0.0) + \
            stage.get("matte", 0.0)
        data = dataset.estimate(name, processed)
        body = dataset.hps.body
        lap("hps")
        if frame is None:
            frame = build_fit_frame(
                cfg, state, body, args.mcube_res, device,
                loop_smpl=args.loop_smpl, loop_cloth=args.loop_cloth,
                patience=args.patience,
                engine=ReconEngine(reconstruction_resolutions(
                    args.mcube_res), pad_multiple=len(mesh) if mesh else 1,
                    device=device),
                marcher=make_marcher(), mesh=mesh)
            lap("setup")

        override = osp.join(args.in_dir, f"{name}_smpl.npz")
        if osp.exists(override):
            init, scale = fit_override(override, body.num_joints)
        else:
            init = {k: data[k].astype(np.float32) for k in
                    ("betas", "body_pose", "global_orient", "trans")}
            # the body's shape space: PIXIE estimates 200 betas and decodes
            # its vertices from the first ones (the JAX CLI passes all 200
            # and fails in the body's blend shapes)
            init["betas"] = init["betas"][:, :body.shapedirs.shape[-1]]
            scale = data["scale"]
        image = torch.as_tensor(data["image"], device=device)
        smpl_fit = frame.fit(
            {"image": data["image"], "mask": data["mask"], "init": init,
             "scale": scale},
            capture_every=max(args.loop_smpl // 20, 1)
            if args.export_video or args.loop_smpl > 1 else 0)
        lap("fit")
        if smpl_fit.losses:
            print(f"  smpl fit: {smpl_fit.losses[0]:.4f} -> "
                  f"{smpl_fit.losses[-1]:.4f} ({stage['fit']:.1f}s)",
                  flush=True)

        faces_np = np.asarray(data["smpl_faces"])
        body_verts = smpl_fit.verts.cpu().numpy()
        if fits:
            save_obj(out_path(name, "_smpl.obj"), body_verts * flip_y,
                     faces_np)
            p = {k: v.cpu().numpy() for k, v in smpl_fit.params.items()}
            np.save(out_path(name, "_smpl.npy"),
                    {"betas": p["betas"], "pose": p["body_pose"],
                     "orient": p["global_orient"], "trans": p["trans"],
                     "scale": scale}, allow_pickle=True)
            if smpl_fit.frames:
                save_gif(out_path(name, "_smpl.gif"), smpl_fit.frames, fps=2)
        nml_f, _ = smpl_fit.normals
        export_overlap(out_path(name, "_overlap.png"), data["image"],
                       nml_f.cpu().numpy(), data["mask"])
        lap("writes")

        verts, faces, stats = frame.recon(image, smpl_fit, calib, scale)
        for k, v in stats.items():
            if k.endswith("overflow") and int(v) > 0:
                print(f"  WARNING: recon {k}={int(v)} — geometry may be "
                      "lost; raise engine budgets", flush=True)
        print(f"  recon: {len(verts)} verts, {len(faces)} faces", flush=True)
        lap("recon")
        n_recon = (len(verts), len(faces))
        meshes = {"body": (body_verts, faces_np), "recon": (verts, faces)}
        save_obj(out_path(name, "_recon.obj"), verts, faces)
        lap("writes")

        closses: List[float] = []
        garments: Dict[str, Tuple[int, int]] = {}
        if len(verts):
            if not args.no_remesh:
                verts, faces = frame.remesh(verts, faces)
                print(f"  remesh: {len(verts)} verts, {len(faces)} faces",
                      flush=True)
                lap("remesh")
            verts_t = torch.as_tensor(verts, device=device)
            faces_t = torch.as_tensor(faces, device=device)
            turntable = [verts_t]             # the pre-refinement mesh
            if args.loop_cloth > 0:
                verts_t, closses = frame.cloth(verts, faces, smpl_fit)
                print(f"  cloth refine: {closses[0]:.4f} -> "
                      f"{closses[-1]:.4f}", flush=True)
                lap("cloth")
                save_obj(out_path(name, "_refine.obj"),
                         verts_t.cpu().numpy(), faces)
                lap("writes")
                turntable.append(verts_t)
            colors = frame.color(verts_t, faces_t, image)
            lap("color")
            meshes["final"] = (verts_t.cpu().numpy(), faces)
            save_obj(out_path(name, "_recon_color.obj"), *meshes["final"],
                     colors.cpu().numpy())
            lap("writes")
            if args.seg_dir is not None:
                garments = extract_garments(args.seg_dir, args.out_dir, name,
                                            *meshes["final"])
                lap("garments")
            if args.export_video:
                meshes["turntable"] = [
                    (v.cpu().numpy(), (colors if v is verts_t else
                                       frame.color(v, faces_t, image))
                     .cpu().numpy()) for v in turntable]
                export_turntable_video(
                    out_path(name, "_cloth.mp4"), data["image"],
                    nml_f.cpu().numpy(), meshes["turntable"], faces,
                    device=device)
                lap("video")
        records.append({"name": name, "stages": stage,
                        "garments": garments,
                        "fit_losses": list(smpl_fit.losses),
                        "cloth_losses": list(closses),
                        "recon": n_recon, "final": (len(verts), len(faces)),
                        "stats": {k: int(v) for k, v in stats.items()
                                  if k != "coarse_occ"}})
        if keep_meshes:
            records[-1]["meshes"] = meshes
        print("  stages (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stage.items()), flush=True)
    print("[infer] done", flush=True)
    return records


if __name__ == "__main__":
    main()
