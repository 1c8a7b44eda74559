#!/usr/bin/env python3
"""Drive the PyTorch port (icon_tpu_torch) of the ICON serving frame on one
NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (lines tagged [1]..[6], then a kernel summary, the card, and a last
JSON line ``{"ok": true, "device": {...}}``):

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the TF32 settings; TF32 is turned off for every later phase, so float32
   convolutions and products stay float32 and comparable;
2. build the CUDA kernels from ``icon_tpu_torch/csrc`` (nvcc, sm_90a);
3. the kNN kernel against its plain PyTorch version at the main path's
   shapes, with CUDA-event medians of both;
4. the slice: first the frame on a small input on the card against the
   same frame on the CPU (plain versions, themselves held to the JAX
   package by the tests); then the frame at full width (bench.py's
   icon-filter config, 512^2 normals, the subdiv-5 body, res 256 -> levels
   33/65/129/257), seeded random weights: 3 warm-up frames, then timed
   frames; level counts and triangle count checked against the JAX
   package's values for the same level set;
5. the rasterizer (plain PyTorch) on the card against the CPU, on the
   subdiv-5 body: the normal renders of the NormalNet frame (512^2,
   azimuth 0 and 180) and the vertex-visibility raster (1024^2), with
   CUDA-event medians of the card's calls;
6. the NormalNet frame (the body's normal renders, NormalNet, filter,
   per-body prep, engine on bench.py's variant field, marching): small on
   the card against the CPU, then at full width (the published NormalNet
   widths at 512^2, the rest as in phase 4): 3 warm-up frames, then timed
   frames; level counts and triangle count checked against the JAX
   package's values for the variant field, predicted normals of unit
   length.

Any failed check raises, so the script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# JAX package reference for the frame's level set at res 256: ReconEngine
# (faster, auto_budget, headroom 1.3) + lattice AutoMarcher of bench.py on
# clothed_human_occ, run on the CPU; the frame's preds * 1e-6 term moves no
# voxel across 0.5 (see CHANGES.md for the command).
JAX_LEVEL1_POINTS = 25491
JAX_LEVEL2_POINTS = 66958
JAX_N_TRIS = 295244
COUNT_RTOL = 0.01
# The same for the NormalNet frame's field, bench.py's variant field
# clip(clothed_human_occ + spurious blobs, 0, 1) (see CHANGES.md).
JAX_VARIANT_LEVEL1_POINTS = 73625
JAX_VARIANT_LEVEL2_POINTS = 150590
JAX_VARIANT_N_TRIS = 584720
RASTER_ATOL = 1e-5
RASTER_FACE_SHARE = 1e-3

KNN_SHAPES = (35937, 98304, 232974)      # level 0, level-1/2 buckets, cap
KEY_RTOL = 1e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` (after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def level0_points(engine, device) -> torch.Tensor:
    """The engine's level-0 lattice as world points [1, N, 3]."""
    g = torch.linspace(0.0, 1.0, engine.resolutions[0], device=device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([xx, yy, zz], -1).reshape(1, -1, 3) * \
        torch.tensor([2.0, -2.0, 2.0], device=device) + \
        torch.tensor([-1.0, 1.0, -1.0], device=device)


def phase_knn(dev, verts_np):
    """Kernel vs plain at the main path's shapes; returns the summary."""
    from icon_tpu_torch.kernels import knn
    rng = np.random.RandomState(0)
    verts = torch.from_numpy(verts_np).to(dev)
    worst = 0.0
    timing = {}
    cases = [(n, 2, kind) for n in KNN_SHAPES for kind in ("cube", "near")]
    cases.append((4096, 8, "cube"))
    for n, k, kind in cases:
        if kind == "cube":
            pts = rng.uniform(-1, 1, (n, 3))
        else:           # within 2 cm of the surface, like boundary queries
            d = rng.normal(size=(n, 3))
            d *= (0.02 * rng.uniform(0, 1, (n, 1)) ** (1 / 3)
                  / np.linalg.norm(d, axis=1, keepdims=True))
            pts = verts_np[rng.randint(0, len(verts_np), n)] + d
        pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
        idx, key = knn.nearest_vertices_kernel(pts, verts, k)
        idx0, key0 = knn.nearest_vertices_plain(pts, verts, k)
        torch.cuda.synchronize()
        err = float((key - key0).abs().max())
        rel = float(((key - key0).abs() / key0.abs().clamp(min=1.0)).max())
        clear = (key0[:, 1] - key0[:, 0]) > 1e-5
        top1 = bool((idx[clear, 0] == idx0[clear, 0]).all())
        ms = cuda_ms(lambda: knn.nearest_vertices_kernel(pts, verts, k))
        plain_ms = cuda_ms(lambda: knn.nearest_vertices_plain(pts, verts, k))
        print(f"[3] knn N={n} V={len(verts_np)} k={k} {kind}: max|dkey| "
              f"{err:.3g} (rel {rel:.3g}) top1 equal where gap>1e-5: {top1} "
              f"({int(clear.sum())}/{n}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        if rel > KEY_RTOL or not top1:
            raise AssertionError(f"knn kernel disagrees with plain at N={n}")
        worst = max(worst, err)
        timing[(n, k, kind)] = (ms, plain_ms)
    ms, plain_ms = timing[(KNN_SHAPES[-1], 2, "near")]
    return {"name": "knn_f32", "route": "cuda",
            "source": "icon_tpu_torch/csrc/knn.cu",
            "replaces": "icon_tpu/ops/pallas/knn.py:60",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_small_frame(dev):
    """The frame at image 64^2, res 128, subdiv-3 body on the card vs on
    the CPU (plain versions): same level counts, near-equal meshes, raw net
    occupancy at the level-0 points to 1e-4."""
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    state = seeded_state(cfg, 1)
    batch = synthetic_icon_batch(np.random.RandomState(1), B=1,
                                 image_size=64, n_samples=8, subdiv=3)
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        fr = build_frame(cfg, state, batch, 128, device)
        stats, _, verts, faces = fr.frame()
        with torch.no_grad():
            raw = fr.net_occ(level0_points(fr.engine, device),
                             fr.columns()[0], fr.features())
        out[name] = (int(stats["level1_points"]), len(verts), len(faces),
                     raw.cpu().numpy(), np.isfinite(verts).all())
    (l1c, nvc, nfc, rawc, _), (l1g, nvg, nfg, rawg, fin) = \
        out["cpu"], out["gpu"]
    err = float(np.abs(rawc - rawg).max())
    print(f"[4] small frame, card vs CPU: level1 {l1c} vs {l1g}, verts {nvc} "
          f"vs {nvg}, tris {nfc} vs {nfg}, raw occupancy max|d| {err:.3g}",
          flush=True)
    if l1c != l1g or abs(nfc - nfg) > 1e-3 * nfc or err > 1e-4 or not fin \
            or nfg < 1000:
        raise AssertionError("small frame on the card disagrees with CPU")


def phase_full_frame(dev, card, iters: int = 5):
    from icon_tpu_torch.kernels import knn
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=512, n_samples=64, subdiv=5)
    t0 = time.perf_counter()
    fr = build_frame(cfg, seeded_state(cfg, 0), batch, 256, dev)
    setup_s = time.perf_counter() - t0

    knn.launches = 0                  # count only the main path's launches
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fr.frame()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        stats, mesh, verts, faces = fr.frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = knn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    _, counts = fr.columns()
    n_over = int((counts > 32).sum())
    l1, l2 = int(stats["level1_points"]), int(stats["level2_points"])
    ov = [int(stats[k]) for k in sorted(stats) if k.endswith("_overflow")]
    print(f"[4] full frame: level1 {l1} (JAX {JAX_LEVEL1_POINTS}), level2 "
          f"{l2} (JAX {JAX_LEVEL2_POINTS}), n_tris {len(faces)} (JAX "
          f"{JAX_N_TRIS}), n_verts {len(verts)}, overflow {ov}, buckets "
          f"{fr.engine._bucket_used}, columns over 32: {n_over}, kNN "
          f"launches {launches}, peak {peak_gb:.2f} GiB, setup "
          f"{setup_s:.2f} s", flush=True)
    print(f"[4] latency per frame (s): median {statistics.median(times):.4f} "
          f"all {[round(x, 4) for x in times]} on {card}, TF32 off",
          flush=True)
    if len(faces) == 0 or not np.isfinite(verts).all():
        raise AssertionError("empty or non-finite mesh")
    if n_over:
        raise AssertionError(f"{n_over} columns exceed 32 crossings")
    if launches <= 0:
        raise AssertionError("the frame never launched the kNN kernel")
    if any(ov):
        raise AssertionError(f"engine budget overflow {ov}")
    for name, got, ref in (("level1_points", l1, JAX_LEVEL1_POINTS),
                           ("level2_points", l2, JAX_LEVEL2_POINTS),
                           ("n_tris", len(faces), JAX_N_TRIS)):
        if abs(got - ref) > COUNT_RTOL * ref:
            raise AssertionError(f"{name} {got} vs JAX {ref}")
    return launches


def phase_raster(dev, verts_np, faces_np):
    """The plain rasterizer on the card against the CPU: the frame's normal
    renders and its visibility raster of the subdiv-5 body."""
    from icon_tpu_torch.ops.raster import rasterize, vertex_visibility
    from icon_tpu_torch.render.render import normal_raster, render_normal

    def on(device):
        v = torch.from_numpy(verts_np).to(device)
        f = torch.from_numpy(faces_np).long().to(device)
        return v, f

    calls = [(f"render_normal 512^2 az {az:g}",
              lambda v, f, az=az: normal_raster(v, f, 512, az, 256),
              lambda v, f, az=az: render_normal(v, f, 512, az, 256))
             for az in (0.0, 180.0)]
    calls.append(("vertex_visibility 1024^2",
                  lambda v, f: rasterize(v, f, v.new_zeros((len(v), 1)),
                                         H=1024, W=1024, K=512),
                  lambda v, f: vertex_visibility(v, f, res=1024)))
    cpu_in, gpu_in = on("cpu"), on(dev)
    for name, raster, call in calls:
        cpu, gpu = raster(*cpu_in), raster(*gpu_in)
        pf, gpf = cpu.pix_to_face, gpu.pix_to_face.cpu()
        covered = pf >= 0
        same = pf == gpf
        share = float((~same & covered).sum()) / max(int(covered.sum()), 1)
        d_attr = float((cpu.attr - gpu.attr.cpu()).abs()[same].max())
        d_depth = float((cpu.depth - gpu.depth.cpu()).abs()[same].max())
        ov = (int(cpu.bin_overflow), int(gpu.bin_overflow))
        vis = ""
        if name.startswith("vertex_visibility"):
            n_vis = int((call(*cpu_in) != call(*gpu_in).cpu()).sum())
            vis = f", vertices whose visibility differs {n_vis}"
        ms = cuda_ms(lambda: call(*gpu_in))
        print(f"[5] {name}: pix_to_face differs at {share:.3g} of "
              f"{int(covered.sum())} covered px, max|d| attr {d_attr:.3g} "
              f"depth {d_depth:.3g} where the faces agree{vis}; "
              f"bin_overflow cpu {ov[0]} card {ov[1]}; card {ms:.4f} ms",
              flush=True)
        if share > RASTER_FACE_SHARE or d_attr > RASTER_ATOL or \
                d_depth > RASTER_ATOL or ov[0] != ov[1]:
            raise AssertionError(f"{name}: the card disagrees with the CPU")


def phase_small_normalnet_frame(dev):
    """The NormalNet frame at image 64^2, res 128, subdiv-3 body on the
    card vs on the CPU (plain versions): same level counts, triangle counts
    within 0.1%, raw net occupancy at the level-0 points to 1e-4."""
    from icon_tpu_torch.recon.frame import (bench_config,
                                            build_normalnet_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    state = seeded_state(cfg, 1, normal_net=True)
    batch = synthetic_icon_batch(np.random.RandomState(1), B=1,
                                 image_size=64, n_samples=8, subdiv=3)
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        fr = build_normalnet_frame(cfg, state, batch, 128, device)
        stats, _, verts, faces = fr.frame()
        with torch.no_grad():
            nml = fr.normals(*fr.render())
            feats = fr.features(*nml)
            smpl = fr.body()
            smpl["smpl_cross_z"], _ = fr.columns(smpl)
            raw = fr.net_occ(level0_points(fr.engine, device), smpl, feats)
        out[name] = (int(stats["level1_points"]), len(faces),
                     raw.cpu().numpy(), torch.cat(nml, -1).cpu().numpy(),
                     np.isfinite(verts).all())
    (l1c, nfc, rawc, nmlc, _), (l1g, nfg, rawg, nmlg, fin) = \
        out["cpu"], out["gpu"]
    err = float(np.abs(rawc - rawg).max())
    print(f"[6] small NormalNet frame, card vs CPU: level1 {l1c} vs {l1g}, "
          f"tris {nfc} vs {nfg}, normals max|d| "
          f"{float(np.abs(nmlc - nmlg).max()):.3g}, raw occupancy max|d| "
          f"{err:.3g}", flush=True)
    if l1c != l1g or abs(nfc - nfg) > 1e-3 * nfc or err > 1e-4 or not fin \
            or nfg < 1000:
        raise AssertionError("small NormalNet frame on the card disagrees "
                             "with the CPU")


def phase_full_normalnet_frame(dev, card, iters: int = 5):
    from icon_tpu_torch.kernels import knn
    from icon_tpu_torch.recon.frame import (bench_config,
                                            build_normalnet_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=512, n_samples=64, subdiv=5)
    t0 = time.perf_counter()
    fr = build_normalnet_frame(cfg, seeded_state(cfg, 0, normal_net=True),
                               batch, 256, dev)
    setup_s = time.perf_counter() - t0

    knn.launches = 0                  # count only the main path's launches
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fr.frame()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        stats, mesh, verts, faces = fr.frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = knn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    with torch.no_grad():
        nml = torch.cat(fr.normals(*fr.render()), -1)[0].reshape(-1, 2, 3)
        smpl = fr.body()
        _, counts = fr.columns(smpl)
    mask = (torch.from_numpy(batch["image"][0]).abs().sum(-1) != 0).to(
        dev).reshape(-1)
    unit_err = float((nml[mask].norm(dim=-1) - 1.0).abs().max())
    n_over = int((counts > 32).sum())
    l1, l2 = int(stats["level1_points"]), int(stats["level2_points"])
    ov = [int(stats[k]) for k in sorted(stats) if k.endswith("_overflow")]
    print(f"[6] full NormalNet frame: level1 {l1} (JAX "
          f"{JAX_VARIANT_LEVEL1_POINTS}), level2 {l2} (JAX "
          f"{JAX_VARIANT_LEVEL2_POINTS}), n_tris {len(faces)} (JAX "
          f"{JAX_VARIANT_N_TRIS}), n_verts {len(verts)}, overflow {ov}, "
          f"buckets {fr.engine._bucket_used}, columns over 32: {n_over}, "
          f"visible vertices {int(smpl['smpl_vis'].sum())}/"
          f"{smpl['smpl_vis'].shape[1]}, normals max||n|-1| {unit_err:.3g} "
          f"over {int(mask.sum())} px, kNN launches {launches}, peak "
          f"{peak_gb:.2f} GiB, setup {setup_s:.2f} s", flush=True)
    print(f"[6] latency per frame (s): median {statistics.median(times):.4f} "
          f"all {[round(x, 4) for x in times]} on {card}, TF32 off",
          flush=True)
    if len(faces) == 0 or not np.isfinite(verts).all():
        raise AssertionError("empty or non-finite mesh")
    if n_over:
        raise AssertionError(f"{n_over} columns exceed 32 crossings")
    if launches <= 0:
        raise AssertionError("the frame never launched the kNN kernel")
    if any(ov):
        raise AssertionError(f"engine budget overflow {ov}")
    if not unit_err <= 1e-4:
        raise AssertionError(f"predicted normals off unit length by "
                             f"{unit_err}")
    for name, got, ref in (("level1_points", l1, JAX_VARIANT_LEVEL1_POINTS),
                           ("level2_points", l2, JAX_VARIANT_LEVEL2_POINTS),
                           ("n_tris", len(faces), JAX_VARIANT_N_TRIS)):
        if abs(got - ref) > COUNT_RTOL * ref:
            raise AssertionError(f"{name} {got} vs JAX {ref}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    from icon_tpu_torch.kernels import build
    from icon_tpu_torch.utils.synthetic import synthetic_body

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 default: cudnn "
          f"{torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[1] TF32 off for all later phases (cudnn and matmul)", flush=True)

    t0 = time.perf_counter()
    so = build.build()
    print(f"[2] built {so} in {time.perf_counter() - t0:.2f} s", flush=True)

    verts_np, faces_np = synthetic_body(subdiv=5)
    summary = phase_knn(dev, verts_np)
    phase_small_frame(dev)
    launches = phase_full_frame(dev, card)
    phase_raster(dev, verts_np, faces_np)
    phase_small_normalnet_frame(dev)
    summary["launches"] = launches + phase_full_normalnet_frame(dev, card)

    print(json.dumps({"kernels": [summary]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
