"""Where the time of a serving frame goes, on one CUDA card.

Builds the frame chip_smoke.py runs at full width (bench.py's icon-filter
config, the subdiv-5 body, res 256, seeded weights), warms it up, then:

1. per-stage host-clock times with a synchronize between stages, median of
   5; ``--frame plain`` (512^2 normals given): filter, crossing columns,
   engine, marching, pack, host decode; ``--frame normalnet`` (512^2 image,
   the published NormalNet widths): the body's normal renders, NormalNet,
   filter, vertex visibility (with projection and cmap), crossing columns,
   engine, marching, pack, host decode;
2. a torch.profiler trace of 2 frames: device time by kernel (top 25) and
   the device's busy share of the wall time.

``--frame fit`` profiles the fit frame's two loops instead (their stage
split is chip_smoke.py's phase 9): 5 iterations of the SMPL fit (512^2,
the subdiv-5 SMPL-X-layout body, the published NormalNet widths) and 5 of
the cloth refinement of the remeshed res-256 reconstruction, each traced
after a warm-up: wall time, device busy share and device time by kernel.

Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.recon.profile_frame [--frame normalnet|fit]
        [--out FILE]

TF32 stays off, as in chip_smoke.py, so the numbers describe the same
float32 frame.
"""

import argparse
import os
import os.path as osp
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def stage_times(fr):
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        feats, t_filter = timed(fr.features)
        (cz, _), t_cols = timed(fr.columns)
        (occ, st), t_eng = timed(lambda: fr.engine(
            fr.query_fn, query_args=(cz, feats)))
        mesh, t_march = timed(lambda: fr.marcher(
            occ, coarse_occ=st["coarse_occ"]))
        tok, t_pack = timed(lambda: fr.marcher.pack(mesh))
        _, t_dec = timed(lambda: fr.marcher.unpack(tok))
    return {"filter": t_filter, "columns": t_cols, "engine": t_eng,
            "march": t_march, "pack": t_pack, "decode": t_dec}


def normalnet_stage_times(fr):
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.no_grad():
        t_f, t_b = timed("render", fr.render)
        nml = timed("normalnet", lambda: fr.normals(t_f, t_b))
        feats = timed("filter", lambda: fr.features(*nml))
        smpl = timed("vis", fr.body)
        smpl["smpl_cross_z"], _ = timed("columns", lambda: fr.columns(smpl))
        occ, st = timed("engine", lambda: fr.engine(
            fr.query_fn, query_args=(smpl, feats)))
        mesh = timed("march", lambda: fr.marcher(
            occ, coarse_occ=st["coarse_occ"]))
        tok = timed("pack", lambda: fr.marcher.pack(mesh))
        timed("decode", lambda: fr.marcher.unpack(tok))
    return times


def trace(fn, n_calls: int):
    """(wall ms, device busy ms, profiler) of ``n_calls`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's self device time repeats the
    # time of the kernels it launched
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    return wall_ms, busy_ms, prof


def fit_loops(cfg, state, iters: int = 5):
    """Trace lines of the fit frame's two loops, ``iters`` iterations each."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import build_fit_frame, variant_occ
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    fr = build_fit_frame(cfg, state, synthetic_smplx_model(subdiv=5), 256,
                         "cuda", loop_smpl=iters, loop_cloth=iters,
                         field=variant_occ)
    item = synthetic_fit_item(fr.body, 512)
    image = torch.from_numpy(item["image"]).cuda()
    fit = fr.fit(item)
    verts, faces, _ = fr.recon(image, fit,
                               torch.from_numpy(item["calib"]).cuda())
    rverts, rfaces = fr.remesh(verts, faces)
    lines = []
    for name, fn in (("fit", lambda: fr.fit(item)),
                     ("cloth", lambda: fr.cloth(rverts, rfaces, fit))):
        fn()                                            # warm-up
        wall_ms, busy_ms, prof = trace(fn, 1)
        lines.append(f"{name} loop, {iters} iterations: wall {wall_ms:.3f} "
                     f"ms, device busy {busy_ms:.3f} ms "
                     f"({100 * busy_ms / wall_ms:.1f}%), idle "
                     f"{100 * (1 - busy_ms / wall_ms):.1f}%")
        lines.append(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40,
            max_name_column_width=70))
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frame", choices=("plain", "normalnet", "fit"),
                    default="plain", help="which serving frame")
    ap.add_argument("--out", default="profile_frame.txt",
                    help="where the stage split and kernel table go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            build_normalnet_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = bench_config()
    if args.frame == "fit":
        lines = [f"card: {card}; torch {torch.__version__}; TF32 off; fit "
                 f"frame loops"]
        lines += fit_loops(cfg, seeded_state(cfg, 0, normal_net=True))
        return write(lines, args.out, [lines[0], lines[1], lines[3]])
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=512, n_samples=64, subdiv=5)
    if args.frame == "plain":
        fr = build_frame(cfg, seeded_state(cfg, 0), batch, 256, "cuda")
        split = stage_times
    else:
        fr = build_normalnet_frame(
            cfg, seeded_state(cfg, 0, normal_net=True), batch, 256, "cuda")
        split = normalnet_stage_times
    for _ in range(3):
        fr.frame()

    runs = [split(fr) for _ in range(5)]
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    total = sum(stages.values())
    lines = [f"card: {card}; torch {torch.__version__}; TF32 off; "
             f"{args.frame} frame",
             "stage medians of 5 synchronized frames (ms):"]
    lines += [f"  {k:8s} {v:9.3f}  {100 * v / total:5.1f}%"
              for k, v in stages.items()]
    lines.append(f"  {'sum':8s} {total:9.3f}")

    wall_ms, busy_ms, prof = trace(fr.frame, 2)
    lines.append(f"profiler, 2 frames: wall {wall_ms:.3f} ms, device busy "
                 f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
                 f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    lines.append(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25,
        max_name_column_width=70))
    return write(lines, args.out, lines[:len(stages) + 4])


def write(lines, out: str, head) -> int:
    """Write ``lines`` to ``out``; print ``head`` and where the rest is."""
    os.makedirs(osp.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(head))
    print(f"full table: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
