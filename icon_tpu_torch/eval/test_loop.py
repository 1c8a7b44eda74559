"""The benchmark evaluation loop (``icon_tpu.eval.test_loop``; reference
apps/ICON.py:519-673 test_step / test_epoch_end).

Per test view: filter the images, reconstruct the occupancy with the
engine in faster mode (its queries signed by ray bins built from the view's
body, since the dataset's known signs belong to the training samples),
march the lattice, then compare with the scan by chamfer and P2S (x100 over
1,000 surface samples) and normal consistency over 4 orthographic renders,
and average per dataset. Both meshes are compared in calib (NDC) space.
With ``num_devices`` > 1 the recon's queries split along the point axis
over a mesh of devices (``parallel.mesh.shard_query``; the engine's point
buffers padded to the mesh's size), as the JAX loop does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from icon_tpu_torch.data.datasets import MAP_KEYS, SHARED_KEYS
from icon_tpu_torch.eval.evaluator import chamfer_p2s, normal_consistency


@torch.no_grad()
def recon_one(model: torch.nn.Module, item: Dict[str, np.ndarray], engine,
              marcher=None, device="cuda", mesh=None):
    """``netG.filter`` + engine + marching for one dataset item
    (ICON.test_single, apps/ICON.py:729-761): (verts, faces) in the
    engine's [-1, 1] world, and the engine's stats. ``mesh``: a device
    mesh the queries shard over (the engine built with ``pad_multiple =
    len(mesh)``)."""
    from icon_tpu_torch.ops.sdf_fast import build_ray_bins
    from icon_tpu_torch.parallel.mesh import Replicas, shard_query
    from icon_tpu_torch.recon.export import extract_mesh

    model.eval()

    def dev(v):
        return torch.as_tensor(np.asarray(v), device=device)

    features = model.filter({k: dev(item[k])[None] for k in MAP_KEYS
                             if k in item})
    calib = dev(item["calib"])[None]
    smpl = {k: dev(v) if k in SHARED_KEYS else dev(v)[None]
            for k, v in item.items()
            if k.startswith(("smpl_", "voxel_"))
            and k != "smpl_query_inside"}
    if "smpl_verts" in smpl and "smpl_vf_table" in smpl:
        rb, rg = build_ray_bins(np.asarray(item["smpl_verts"]),
                                np.asarray(item["smpl_faces"]))
        smpl["smpl_ray_bins"] = dev(rb)
        smpl["smpl_ray_grid"] = dev(rg)
    if model.prior_type == "pamir":
        smpl["voxel_feats"] = model.volume_features(
            smpl["voxel_verts"], smpl["voxel_codes"])
    model_on = Replicas(model)

    def query_fn(pts, features, calib, smpl):
        return model_on(pts.device).query(features, pts, calib,
                                          smpl or None)[-1]

    if mesh is not None:
        query_fn = shard_query(query_fn, mesh)
    occ, stats = engine(query_fn, query_args=(features, calib, smpl))
    verts, faces = extract_mesh(occ, marcher=marcher)
    return verts, faces, stats


def world_to_ndc(verts: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """Engine-world verts -> calib/NDC space via the net's projection."""
    h = np.concatenate([verts, np.ones((len(verts), 1), verts.dtype)], 1)
    return (h @ calib.T)[:, :3]


def run_evaluation(cfg, dataset, model: torch.nn.Module,
                   mcube_res: Optional[int] = None, num_samples: int = 1000,
                   nc_size: int = 512, max_items: int = 0, device="cuda",
                   records: Optional[list] = None, num_devices: int = 1
                   ) -> Dict[str, Dict[str, float]]:
    """Evaluate every test view (or the first ``max_items``); returns
    {dataset: {metric: mean}} and prints the benchmark table (reference
    test_epoch_end, ICON.py:647-673). ``records``, when given, receives one
    dict per item: its metrics, the level counts, its seconds and the two
    meshes that normal consistency renders (the render's world frame).
    ``num_devices`` > 1 point-shards the recon's queries over that many
    devices of ``device``'s kind (CPU shards on the CPU)."""
    from icon_tpu_torch.data.datasets import projection_np
    from icon_tpu_torch.recon.engine import (ReconEngine,
                                             reconstruction_resolutions)
    from icon_tpu_torch.recon.export import make_marcher
    from icon_tpu_torch.parallel.mesh import make_mesh
    from icon_tpu_torch.utils.io import clean_mesh

    mesh = None
    if num_devices > 1:
        mesh = make_mesh(num_devices, device)
        print(f"[eval] point-sharding recon over {len(mesh)} devices")
        if cfg.net.norm_mlp == "group":
            from icon_tpu_torch.parallel.mesh import GROUP_NORM_WARNING
            print(f"[eval] {GROUP_NORM_WARNING}")
    res = mcube_res or cfg.mcube_res
    engine = ReconEngine(reconstruction_resolutions(res),
                         pad_multiple=len(mesh) if mesh else 1,
                         device=device)
    marcher = make_marcher()
    accum: Dict[str, Dict[str, List[float]]] = {}
    n = min(len(dataset), max_items) if max_items else len(dataset)
    for i in range(n):
        t0 = time.perf_counter()
        item = dataset[i]
        verts_pr, faces_pr, stats = recon_one(model, item, engine, marcher,
                                              device, mesh)
        if cfg.clean_mesh and len(verts_pr):
            verts_pr, faces_pr = clean_mesh(verts_pr, faces_pr)
        if not len(verts_pr):
            print(f"[eval] {item['subject']}/{item['rotation']}: "
                  "EMPTY recon, skipped")
            continue
        # engine world -> calib space; world = grid * (1, -1, 1) (the
        # engine's y-flipped box)
        world = verts_pr * np.array([1, -1, 1], np.float32)
        pr_ndc = world_to_ndc(world, item["calib"])
        gt_ndc = projection_np(item["verts"], item["calib"])
        chamfer, p2s = chamfer_p2s(pr_ndc, faces_pr, gt_ndc, item["faces"],
                                   num_samples=num_samples, device=device)
        flip = np.array([1, -1, -1], np.float32)
        nc = normal_consistency(pr_ndc * flip, faces_pr, gt_ndc * flip,
                                item["faces"], size=nc_size, device=device)
        # bucket per dataset and noise setting (apps/ICON.py:539-541)
        dname = str(item["subject"]).split("/")[0]
        ns = tuple(getattr(cfg.dataset, "noise_scale", ()) or ())
        if any(s > 0 for s in ns):
            dname = f"{dname}@noise{list(ns)}"
        bucket = accum.setdefault(dname, {"chamfer": [], "p2s": [], "NC": []})
        bucket["chamfer"].append(chamfer)
        bucket["p2s"].append(p2s)
        bucket["NC"].append(nc)
        seconds = time.perf_counter() - t0
        levels = {k: int(v) for k, v in stats.items() if k.endswith("points")}
        if records is not None:
            records.append({"subject": item["subject"],
                            "rotation": item["rotation"], "chamfer": chamfer,
                            "p2s": p2s, "NC": nc, "levels": levels,
                            "n_tris": int(len(faces_pr)), "s": seconds,
                            "meshes": ((pr_ndc * flip, faces_pr),
                                       (gt_ndc * flip, item["faces"]))})
        print(f"[eval] {item['subject']} rot={item['rotation']}: "
              f"chamfer={chamfer:.4f} p2s={p2s:.4f} NC={nc:.4f} "
              f"levels={levels} s={seconds:.3f}")

    table = {d: {k: float(np.mean(v)) for k, v in m.items()}
             for d, m in accum.items()}
    print("\n=== benchmark (x100 chamfer/P2S; NC: sum sq diff / 4 views) ===")
    for dname, row in table.items():
        cells = "  ".join(f"{k}={v:.4f}" for k, v in row.items())
        print(f"  {dname}: {cells}")
    return table
