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
   (the H and W pass's);
3. the backward at PaMIR's k = 11, on that input (the dense footprint:
   ~20,500 touched voxels) and on ``chip_smoke.py`` phase 18a's (phase
   13's small pamir fit frame through ``pamir_feats``: the tetra body's
   642 vertices and 7,358 at the padding point), from one forward's
   output and weight and a seeded output gradient. For each version in
   ``--order`` (this tree, ``change``, and another checkout, ``parent``,
   given by ``--parent DIR`` and imported as a package copy of its own
   that builds its kernels into its own ``_build``): the device time of a
   gradient by kernel, with its launches (torch.profiler over 20 calls of
   ``_Voxelize.backward`` on the same saved tensors, so any two checkouts
   compare), the call's time with its host dispatch (CUDA events), and
   its forward kernels alone; before the rounds each version's gradients
   are held bit for bit to this tree's plain twins. Then this tree's
   ``box_smooth3d_bwd`` alone (``_smooth_bwd``), split by launch (the
   zeroing of its count and marks, the mark launch, the bricks), with
   the bricks it listed; and an empty kernel's time
   (``torch.cuda._sleep(0)``), the floor of a launch.

Each time "alone" is the median of 5 CUDA-event timings of 20 launches
queued behind a device sleep. Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.kernels.profile_voxelize [--parent DIR] \\
        [--order parent,change,change,parent] [--out FILE]
"""

import argparse
import json
import os
import os.path as osp
import statistics
import subprocess
import sys
import types

import numpy as np
import torch

from icon_tpu_torch.kernels.profile_marching import call_ms, load_checkout

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


def voxel_input(dev, body_verts=None):
    """(verts [1, 8000, 3], codes [8000, 3]): the body's first 8,000
    vertices (``body_verts``, the subdiv-5 synthetic body's by default)
    and their normalized coordinates."""
    from icon_tpu_torch.utils.synthetic import synthetic_body
    v = synthetic_body(subdiv=5)[0] if body_verts is None else body_verts
    codes = (v - v.min(0)) / (v.max(0) - v.min(0))
    verts = (v[:VERTS] * 1.4).astype(np.float32)
    return (torch.from_numpy(verts[None]).to(dev),
            torch.from_numpy(codes[:VERTS].astype(np.float32)).to(dev))


def frame_input(dev):
    """(verts [1, 8000, 3], codes [8000, 3]): ``chip_smoke.py`` phase 13's
    pamir voxel input, which phase 18a differentiates: the small pamir
    fit frame's body (the subdiv-3 SMPL-X layout at 64^2, ``-loop_smpl
    0``, seed 1) through ``pamir_feats`` with the tetra body."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import (bench_config, build_fit_frame,
                                            load_tetra, pamir_feats,
                                            seeded_state, variant_occ)
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    cfg = bench_config("pamir")
    frame = build_fit_frame(cfg, seeded_state(cfg, 1, normal_net=True),
                            synthetic_smplx_model(subdiv=3), 128, dev,
                            loop_smpl=0, loop_cloth=1, field=variant_occ)
    item = synthetic_fit_item(synthetic_smplx_model(subdiv=3), 64, seed=1)
    fit = frame.fit(item)
    vox = pamir_feats(fit.verts, frame.body, fit.params,
                      float(item["scale"]),
                      torch.from_numpy(item["calib"]).to(dev), load_tetra())
    return vox["voxel_verts"], vox["voxel_codes"]


def device_split(fn, reps: int = 20) -> dict:
    """{"ms": device ms a call, "launches": {kernel: [ms a launch,
    launches a call]}} of ``fn()`` over ``reps`` calls between two device
    sleeps (torch.profiler; "ms" sums each kernel's mean launch times
    its launches a call, rounded, since the profiler may drop a few of a
    window's launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)   # the calls well inside the window
        for _ in range(reps):
            fn()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    out = {"ms": 0.0, "launches": {}}
    for e in prof.key_averages():
        if e.device_time_total <= 0 or "spin" in e.key or "sleep" in e.key:
            continue
        ms, per_call = e.device_time_total / e.count / 1e3, e.count / reps
        out["ms"] += ms * max(round(per_call), 1)
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        out["launches"][name[-60:]] = [round(ms, 5), per_call]
    return out


def backward_case(versions: dict, order, verts, codes, dev) -> dict:
    """Section 3 on one input (see the module's docstring)."""
    from icon_tpu_torch.kernels import voxelize as kv
    from icon_tpu_torch.ops import voxelize as pv
    out, weight = kv.box_smooth3d(kv.voxel_splat(verts, codes, RES).view(
        1, RES, RES, RES, 4), K, keep_weight=True)
    g_out = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(19))
    want = pv.voxel_splat_bwd_plain(verts, codes, pv.box_smooth3d_bwd_plain(
        g_out, out, weight, K).view(1, -1, 4), RES)
    ctx = types.SimpleNamespace(saved_tensors=(verts, codes, out, weight),
                                res=RES, k=K,
                                needs_input_grad=(True, True, False, False))
    rows = pv.touched_rows(verts, RES)
    calls = {}
    for name, mod in versions.items():
        got = mod._Voxelize.backward(ctx, g_out)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}'s backward differs from the plain "
                                 "twins")
        calls[name] = lambda mod=mod: mod._Voxelize.backward(ctx, g_out)
    pads = int((verts[0] == verts[0, -1]).all(-1).sum())
    res = {"vertices": verts.shape[1], "at_the_last_point": pads,
           "rows": int(rows.numel()), "rounds": []}
    acc = torch.empty((1, RES ** 3, 4), device=dev)
    acc5 = acc.view(1, RES, RES, RES, 4)
    t1 = torch.empty_like(acc5)
    vol = torch.empty(acc5.shape[:4] + (3,), device=dev)
    for name in order:
        mod = versions[name]
        res["rounds"].append({
            "version": name, "backward": device_split(calls[name]),
            "backward_call_ms": call_ms(calls[name]),
            "voxel_splat_ms": kernel_ms(lambda: mod._splat(verts, codes, RES,
                                                           acc)),
            "box_smooth3d_ms": kernel_ms(lambda: mod._smooth(acc5, K, t1,
                                                             vol))})
    twin = pv.box_smooth3d_bwd_rows_plain(g_out, out, weight, K, rows)
    scratch = kv._bwd_scratch(1, RES, K, dev)
    g_acc = torch.empty(out.shape[:4] + (4,), device=dev)

    def launch():
        kv._smooth_bwd(g_out, out, weight, K, verts, scratch, g_acc)
    launch()
    torch.cuda.synchronize()
    if not torch.equal(g_acc.view(-1, 4)[rows], twin):
        raise AssertionError("box_smooth3d_bwd differs from its twin")
    res["box_smooth3d_bwd"] = {"bricks": int(scratch[0]),
                               "kernel_ms": kernel_ms(launch),
                               "device": device_split(launch)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_voxelize.json")
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--order", default="parent,change,change,parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_voxelize: no CUDA card", file=sys.stderr)
        return 2
    order = args.order.split(",")
    if "parent" in order and not args.parent:
        ap.error("--parent is needed for the parent's rounds")
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

    versions = {}
    if "parent" in order:
        versions["parent"] = load_checkout(args.parent, ("kernels.voxelize",),
                                           lambda mod: mod._load())[0]
    if "change" in order:
        versions["change"] = kv
    inputs = {"dense": (verts, codes), "phase18a": frame_input(dev)}
    result["backward"] = {}
    for name, (v, c) in inputs.items():
        result["backward"][name] = backward_case(versions, order, v, c, dev)
        print(json.dumps({name: result["backward"][name]}), flush=True)
    result["empty_kernel_ms"] = kernel_ms(lambda: torch.cuda._sleep(0))
    print(f"empty kernel: {result['empty_kernel_ms']:.4f} ms", flush=True)
    print(card)
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if result["smooth"]["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
