"""The dataset renderer's CLI (``icon_tpu.apps.render``; reference
scripts/render_single.py:144-239 and render_batch.sh): every subject of
``{root}/{dataset}/scans/*`` (with its fit ``fits/*``, where one exists)
rendered into the ``{root}/{dataset}_{R}views`` layout that
``PIFuDataset`` and ``NormalDataset`` read.

    python -m icon_tpu_torch.apps.render -root ./data -dataset thuman2 \\
        -views 36 -size 512 -procs 1 [-prt -prt_dirs 64] [-vis_res 4096] \\
        [-subjects ...]

Per subject:

- the scan ``scans/{s}/{s}.obj`` is normalized the reference's way
  (render_single.py:79-95): its height to 1.8 box units, centred at the
  pelvis joint in x and z and at the bounding box's mid-height in y;
- the SMPL-X fit ``fits/{s}/smplx_param.pkl`` poses the body through
  ``get_smpl_model("smplx")`` (the installed model, else the synthetic
  stand-in) for the T-normal and visibility channels. A subject without a
  fit file renders without them; a fit that fails to load or pose raises;
- ``-prt`` lights the renders by self-shadowed PRT transport
  (``data/render_dataset.py:compute_prt``, ``-prt_dirs`` depth rasters).

The renders, the PRT rasters and the visibility run on ``device`` (the card
unless the caller asks for the CPU), in this process or, with ``-procs``
> 1 and more than one subject, in a pool of spawned worker processes (CUDA
cannot be forked once initialised), each on the same device. The pool is
closed in a ``finally``, so no worker outlives :func:`main`. An error in a
subject's render ends the run; :func:`main` returns each subject's record.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import time
from typing import List, Optional

import numpy as np
import torch


def list_subjects(root: str, dataset: str):
    scans = sorted(glob.glob(osp.join(root, dataset, "scans", "*")))
    return [osp.basename(p) for p in scans if osp.isdir(p)]


def _find_scan(root: str, dataset: str, subject: str):
    for pat in (f"{subject}.obj", "*.obj"):
        hits = sorted(glob.glob(
            osp.join(root, dataset, "scans", subject, pat)))
        if hits:
            return hits[0]
    return None


def _posed_body(fit_path: str, dev: torch.device):
    """(verts [V, 3], pelvis [3], faces) of the fit's SMPL-X body in scan
    units, on the host."""
    from icon_tpu_torch.models.smplx.assets import (get_smpl_model,
                                                    load_smplx_param)
    param = load_smplx_param(fit_path)
    model = get_smpl_model("smplx").to(dev)
    with torch.no_grad():
        verts, joints = model(**{
            k: torch.as_tensor(param[k], dtype=torch.float32, device=dev)
            for k in ("betas", "global_orient", "body_pose",
                      "left_hand_pose", "right_hand_pose", "expression")})
    scale = float(param["scale"])
    trans = np.asarray(param["translation"], np.float32)
    return (verts[0].cpu().numpy() * scale + trans,
            joints[0, 0].cpu().numpy() * scale + trans, model.faces)


def load_subject(root: str, dataset: str, subject: str, device="cuda"):
    """(scan verts, scan faces, body verts or None, body faces or None) of
    one subject, normalized the reference's way; None without a scan."""
    from icon_tpu_torch.utils.io import load_obj
    scan_path = _find_scan(root, dataset, subject)
    if scan_path is None:
        return None
    scan_v, scan_f = load_obj(scan_path)

    fit_path = osp.join(root, dataset, "fits", subject, "smplx_param.pkl")
    body_v = body_f = joints0 = None
    if osp.exists(fit_path):
        body_v, joints0, body_f = _posed_body(fit_path,
                                              torch.device(device))

    # normalization (render_single.py:79-95): height -> 1.8 of the box,
    # center = pelvis (x, z) + bbox mid-height (y)
    vmin, vmax = scan_v.min(0), scan_v.max(0)
    scale = 1.8 / max(vmax[1] - vmin[1], 1e-6)
    center = joints0.copy() if joints0 is not None else \
        (vmin + vmax) / 2.0
    center[1] = 0.5 * (vmax[1] + vmin[1])
    scan_n = (scan_v - center) * scale
    body_n = (body_v - center) * scale if body_v is not None else None
    return scan_n, scan_f, body_n, body_f


def render_one(root: str, dataset: str, subject: str, views: int,
               size: int, prt_dirs: int, vis_res: int, seed: int,
               device="cuda") -> dict:
    """Render one subject; returns its record (``status`` "rendered" or
    "no scan obj", the output folder, whether the body was rendered, the
    seconds of the PRT and of the whole subject)."""
    from icon_tpu_torch.data.render_dataset import (compute_prt,
                                                    render_subject_views)
    t0 = time.perf_counter()
    dev = torch.device(device)
    rec = {"subject": subject, "status": "no scan obj", "body": False}
    loaded = load_subject(root, dataset, subject, dev)
    if loaded is None:
        return rec
    scan_n, scan_f, body_n, body_f = loaded

    prt = None
    t_prt = time.perf_counter()
    if prt_dirs:
        prt = compute_prt(scan_n, scan_f, n_dirs=prt_dirs, device=dev)
    t_prt = time.perf_counter() - t_prt

    rotations = list(range(0, 360, 360 // views))
    out_dir = osp.join(root, f"{dataset}_{views}views", subject)
    render_subject_views(out_dir, scan_n.astype(np.float32), scan_f,
                         body_n, body_f, rotations, size=size, seed=seed,
                         prt=prt, vis_res=vis_res or None, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.update(status="rendered", out_dir=out_dir, views=len(rotations),
               body=body_n is not None, prt_s=t_prt,
               seconds=time.perf_counter() - t0)
    return rec


def _worker_init() -> None:
    torch.set_num_threads(1)


def _worker(job) -> dict:
    return render_one(*job)


def _message(rec: dict) -> str:
    if rec["status"] != "rendered":
        return f"{rec['subject']}: {rec['status']}"
    return (f"{rec['subject']}: {rec['views']} views -> {rec['out_dir']} "
            f"({rec['seconds']:.2f} s" + ("" if rec["body"] else
                                          ", no fit: no body") + ")")


def _render_pool(jobs, procs: int) -> List[dict]:
    """The jobs in a spawn pool of ``procs`` workers, closed and joined in
    a ``finally``. The resource tracker that the pool's semaphores start
    is stopped once they are gone, when the pool started it; a worker's
    error is raised after that, without the pool's frames (its remote
    traceback stays as its ``__cause__``)."""
    import gc
    import multiprocessing as mp
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    had_tracker = tracker._pid is not None
    pool = mp.get_context("spawn").Pool(procs, initializer=_worker_init)
    records, error = [], None
    try:
        for rec in pool.imap_unordered(_worker, jobs):
            print(_message(rec), flush=True)
            records.append(rec)
    except BaseException as e:
        error = e.with_traceback(None)
    finally:
        pool.terminate()
        pool.join()
    del pool
    gc.collect()                     # the semaphores unregister
    if not had_tracker:
        tracker._stop()
    if error is not None:
        raise error
    return records


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="icon_tpu_torch.apps.render")
    ap.add_argument("-root", required=True)
    ap.add_argument("-dataset", default="thuman2")
    ap.add_argument("-views", type=int, default=36)
    ap.add_argument("-size", type=int, default=512)
    ap.add_argument("-procs", type=int, default=max(os.cpu_count() - 2, 1))
    ap.add_argument("-prt", action="store_true",
                    help="self-shadow PRT transport for shaded renders")
    ap.add_argument("-prt_dirs", type=int, default=64)
    ap.add_argument("-vis_res", type=int, default=0,
                    help="SMPL visibility raster res (default 4096)")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-subjects", nargs="*", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, device="cuda") -> List[dict]:
    """Render every subject on ``device`` (the card unless the caller asks
    for the CPU); returns the subjects' records in their order."""
    args = parse_args(argv)
    subjects = args.subjects or list_subjects(args.root, args.dataset)
    if not subjects:
        raise SystemExit(
            f"no subjects under {args.root}/{args.dataset}/scans")
    device = str(torch.device(device))
    jobs = [(args.root, args.dataset, s, args.views, args.size,
             args.prt_dirs if args.prt else 0, args.vis_res,
             args.seed + i, device) for i, s in enumerate(subjects)]
    t0 = time.perf_counter()
    if args.procs <= 1 or len(jobs) == 1:
        records = []
        for job in jobs:
            records.append(render_one(*job))
            print(_message(records[-1]), flush=True)
    else:
        records = _render_pool(jobs, min(args.procs, len(jobs)))
        records.sort(key=lambda r: subjects.index(r["subject"]))
    print(f"done: {len(jobs)} subjects in {time.perf_counter() - t0:.1f} s")
    return records


if __name__ == "__main__":
    main()
