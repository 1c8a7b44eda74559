"""Where the time of the voxelize kernels goes, on one CUDA card.

What ``chip_smoke.py``'s phase 13 does not time: PaMIR's voxel input at
its real size with no padding (the first 8,000 vertices of the subdiv-5
synthetic body, coded by their normalized coordinates), splatted into a
128^3 volume and smoothed with k = 11. On the card, with TF32 off:

1. ``voxel_splat`` alone beside the zeroing of its accumulator alone
   (``zero_``), the floor of its memset;
2. ``box_smooth3d`` alone, held bit for bit to the plain version, its two
   passes' device times (torch.profiler), and the two copies that move the
   passes' compulsory bytes: the accumulator into the scratch (``copy_``,
   the D pass's read and write) and the scratch's codes into the volume
   (the H and W pass's).

Each time is the median of 5 CUDA-event timings of 20 launches queued
behind a device sleep. Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.kernels.profile_voxelize [--out FILE]
"""

import argparse
import json
import os
import os.path as osp
import statistics
import subprocess
import sys

import numpy as np
import torch

RES, K, VERTS = 128, 11, 8000


def kernel_ms(launch, reps: int = 20) -> float:
    """Median over 5 runs of the CUDA-event time per launch of ``reps``
    back-to-back ``launch()`` calls behind a device sleep."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def voxel_input(dev):
    """(verts [1, 8000, 3], codes [8000, 3]): the body's first 8,000
    vertices and their normalized coordinates."""
    from icon_tpu_torch.utils.synthetic import synthetic_body
    v, _ = synthetic_body(subdiv=5)
    codes = (v - v.min(0)) / (v.max(0) - v.min(0))
    verts = (v[:VERTS] * 1.4).astype(np.float32)
    return (torch.from_numpy(verts[None]).to(dev),
            torch.from_numpy(codes[:VERTS].astype(np.float32)).to(dev))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_voxelize.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_voxelize: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from icon_tpu_torch.kernels import voxelize as kv
    from icon_tpu_torch.ops import voxelize as pv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    verts, codes = voxel_input(dev)
    buf = torch.empty((1, RES ** 3, 4), device=dev)
    result = {"card": card, "splat": {
        "kernel_ms": kernel_ms(lambda: kv._splat(verts, codes, RES, buf)),
        "zero_ms": kernel_ms(lambda: buf.zero_())}}
    print(f"splat, unpadded: {result['splat']}", flush=True)

    acc = pv.voxel_splat_plain(verts, codes, RES).view(1, RES, RES, RES, 4)
    want = pv.box_smooth3d_plain(acc, K)
    t1 = torch.empty_like(acc)
    vol = torch.empty(acc.shape[:4] + (3,), device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kv._smooth(acc, K, t1, vol)
        torch.cuda.synchronize()
    passes = {e.key: e.device_time_total / e.count / 1e3
              for e in prof.key_averages()
              if e.device_time_total > 0 and "smooth" in e.key}
    result["smooth"] = {
        "identical": bool(torch.equal(vol, want)),
        "kernel_ms": kernel_ms(lambda: kv._smooth(acc, K, t1, vol)),
        "passes_ms": passes,
        "copy_acc_ms": kernel_ms(lambda: t1.copy_(acc)),
        "copy_codes_ms": kernel_ms(lambda: vol.copy_(t1[..., :3])),
        "geometry": kv.smooth_geometry(K)._asdict()}
    print(f"smooth: {result['smooth']}", flush=True)
    print(card)
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if result["smooth"]["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
