#!/usr/bin/env python3
"""Drive the PyTorch port (icon_tpu_torch) of the ICON serving frame on one
NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (lines tagged [1]..[13], then a kernel summary, the card, and a last
JSON line ``{"ok": true, "device": {...}}``):

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the TF32 settings; TF32 is turned off for every later phase, so float32
   convolutions and products stay float32 and comparable;
2. build the CUDA kernels from ``icon_tpu_torch/csrc`` (nvcc, sm_90a), and
   show that the kNN kernel issues tensor-core instructions (``cuobjdump
   -sass``: its HMMA count and first HMMA line);
3. the kNN kernel against its plain PyTorch version at the main path's
   shapes (run after phase 4's full frame, whose engine gives the level-1
   and level-2 buckets it used): the level-0 lattice against the
   mirror-symmetric subdiv-5 body (indices identical on every row, exact
   ties included), the two buckets and the 232,974-point cap near the body
   and in the cube, and k=8: keys to 1e-5 relative, every pick's index
   equal wherever the keys on both sides of it are more than 1e-5 apart;
   the kernel alone (its launches on preallocated outputs, behind a device
   sleep) and the whole wrapper call timed at each shape beside the bound;
4. the slice: first the frame on a small input on the card against the
   same frame on the CPU (plain versions, themselves held to the JAX
   package by the tests); then the frame at full width (bench.py's
   icon-filter config, 512^2 normals, the subdiv-5 body, res 256 -> levels
   33/65/129/257), seeded random weights: 3 warm-up frames, then timed
   frames; level counts and triangle count checked against the JAX
   package's values for the same level set;
5. the rasterizer on the card (the raster_fwd kernel) against the CPU's
   plain version, on the subdiv-5 body: the normal renders of the NormalNet
   frame (512^2, azimuth 0 and 180) and the vertex-visibility raster
   (1024^2), with CUDA-event medians of the card's calls;
6. the NormalNet frame (the body's normal renders, NormalNet, filter,
   per-body prep, engine on bench.py's variant field, marching): small on
   the card against the CPU, then at full width (the published NormalNet
   widths at 512^2, the rest as in phase 4): 3 warm-up frames, then timed
   frames; level counts and triangle count checked against the JAX
   package's values for the variant field, predicted normals of unit
   length;
7. the rasterizer kernels (raster_setup, raster_bin, raster_fwd,
   raster_bwd) against the plain version on the card, at the demo's shapes
   (512^2 normal renders with K=256 and the fit's K=96; the 1024^2
   visibility raster with K=512): the setup's pixel coordinates and depths
   and the bin kernel's face lists, counts and overflow identical to the
   plain binning's, pix_to_face identical on every pixel, the images' and
   the gradients' errors; CUDA-event medians of each kernel alone (its
   launches on preallocated buffers, queued behind a sleep so that host
   dispatch does not count) beside those of the whole forward and
   backward call, and each kernel's bound on this input;
8. the fit frame (SMPL fit, recon, remesh, cloth refinement, colours) small
   on the card against the CPU: per-iteration fit losses, level and
   triangle counts; from the CPU's fitted body and remeshed mesh, the
   card's raw net occupancy and cloth losses;
9. the fit frame at full width (the subdiv-5 SMPL-X-layout body, a 512^2
   matted image, 100 fit iterations, recon at res 256 on bench.py's variant
   field, remesh, 200 cloth iterations, colours): per-stage times, losses,
   kernel launches and peak memory; level counts against the JAX
   package's; the raster kernels against the plain version, as in phase 7,
   on the frame's own meshes (the fitted body at K=96, the cloth loop's
   input and output at K=256, the remeshed mesh and the colour stage's
   refined mesh at 1024^2 with K=512) with their bin lists and overflow;
   then a known-answer fit (refine_smpl toward the body's own render at
   seeded betas must lower its loss);
10. the demo CLI (``icon_tpu_torch.apps.infer.main``) from two photos it
   writes from seeds (the 24-joint synthetic SMPL's silhouette as the alpha
   of colour noise, and the same figure as RGB on a textured background,
   which takes the saliency path), with a full-width YAML config (bench.py's
   icon-filter widths, the published NormalNet), seeded reference-layout
   ``.ckpt`` files (the MLP's last layer reading the body's signed
   distance, so the recon is body-shaped) and a seeded PyMAF ``.pt``
   (published geometry, its regressor heads scaled down so that the
   estimate stays near the mean body): ``-loop_smpl 100 -loop_cloth 200
   -no_remesh -img_size 512 -mcube_res 256``; PyMAF's items on the card
   against the CPU (1e-3 of each array's largest magnitude), the artifact
   set, finite losses, and the per-image stage split; then the kernels
   against their plain versions on the run's own inputs: every kNN call
   (the recon engine's level points against the padded fitted body) as in
   phase 3, and per photo the raster kernels as in phase 7 on the fitted
   body (K=96), the cloth loop's input and output (K=256, azimuth 0 and
   180), and the recon's and the colour stage's visibility rasters (1024^2,
   K=512);
11. the rest of the photo path: the CLI on the RGB scene photo with
   seeded weight files in their published layouts under a temporary
   ``ICON_TPU_DATA_DIR/HPS`` (a darknet ``yolov3-tiny.weights`` whose
   heads box the whole frame, the full ``u2net.pth``, PARE's
   ``pare_checkpoint.ckpt`` at HRNet-W32) and a garment JSON: ``-hps_type
   pare -export_video -seg_dir``, 100 fit and 200 cloth iterations,
   ``-no_remesh``. Before it, YOLO's heads, U^2-Net's seven logit maps and
   PARE's outputs on the card against the CPU on the CLI's own inputs
   (NET_RTOL of each array's largest magnitude) and the same person box;
   after it, the stage split (``detect``, ``matte``, ``hps``, ``video``,
   ``garments`` among them), the mp4's 360 frames read back with cv2, the
   garment OBJs' sizes against the CPU's ``extract_cloth``, and the raster
   kernels against the plain version on both turntable meshes at azimuths
   0, 90, 180 and 270 (256^2, K=128, forward only: bin lists, pix_to_face,
   overflow and the composited uint8 frame identical), with the whole
   frame's CUDA-event time;
12. the demo's other estimators: seeded files in their published layouts
   and widths under a temporary ``ICON_TPU_DATA_DIR/HPS`` (PIXIE's
   ``pixie_model.tar``: HRNet-W48 and two ResNet-50s; HybrIK's
   ``pretrained_w_cam.pth``: ResNet-34 at 256^2); both nets on the card
   against the CPU on the CLI's own input (NET_RTOL of each array's largest
   magnitude; HybrIK's IK on its chain body by its swings, on SMPL's tree
   against the CPU), with each wrapper's build and load time and each
   forward alone; then the CLI on the RGB scene photo with ``-hps_type
   pixie`` (the SMPL-X body: 21 body joints, its faces) and with
   ``-hps_type hybrik``, 100 fit and 200 cloth iterations, ``-no_remesh``:
   the stage split, the artifacts, the loops, the recon; and the kernels
   against their plain versions on the PIXIE run's inputs, as in phase 10
   (every kNN call against the SMPL-X body; the raster kernels on its
   fitted body, recon and refined mesh);
13. the pifu and pamir priors: small fit frames (image 64^2, res 128,
   ``-loop_smpl 0``, bench.py's widths for the prior, the variant field)
   on the card against the CPU (raw net occupancy from the CPU's body to
   1e-4, level and triangle counts equal); the voxelize kernels against
   their plain versions on the small pamir frame's own voxel inputs at
   128^3 and on a stress input with 7,358 of the 8,000 vertices at the
   frame's padding point (``box_smooth3d`` bit-identical, ``voxel_splat``
   within 2 m 2^-24 of each voxel's sum of m non-negative terms), the
   smooth's division by k against IEEE division for every float32
   significand, each kernel alone beside its bound, its plain version, its
   library call (``index_add_``, ``avg_pool3d``) and its time in the
   previous design (``PERF.md`` §6, "Before"); the pamir serving frame at full width (the subdiv-5
   body, 512^2 normals, the 128^3 volume with 32 features, MLP
   38-512-256-128-1, res 256 on the variant field): 3 warm-up and 5 timed
   recons with the stage split (filter; prep = voxelize and the volume
   encoder; engine; march; decode), peak memory, level counts against the
   JAX package's; then the CLI on the RGB scene photo with a pifu config
   (no filter: its seeded readout extrudes the photo's silhouette) and a
   pamir config, seeded reference-layout ``.ckpt`` files (pamir's with the
   volume encoder's dead modules), ``-loop_smpl 100 -loop_cloth 20
   -no_remesh``: the artifact set per prior (no ``_smpl.*`` for pifu), the
   loops, the recon, the stage split, and every voxelize launch of the
   pamir run held to the plain version on that launch's inputs.

Each main path (phases 4, 6, 9, 10, 11, both runs of 12, and in 13 the
pamir frame and both CLI runs) runs with the kernels' launch counts set to
0 just before it and read just after; a kernel of the path that did not
launch fails the run. Any failed check raises, so the script exits
non-zero and prints no result.

The kernel summary gives, for every kernel, its launches in the main
paths, its error against the plain version, its time and the plain
version's, its bound (the larger of the bytes it must move over the card's
memory rate and its operations over the float32 peak, from this run's
inputs; for the kNN also its tensor-core products over the TF32 peak and
one compare per pair over the float32 instruction rate) and the time of
one PyTorch call computing the same function where one exists (the kNN's
``cdist`` + ``topk``, the splat's ``index_add_``, the smooth's
``avg_pool3d``; none for the rasterizer).
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

KNN_LEVEL0, KNN_CAP = 35937, 232974       # the 33^3 lattice, the cap
KEY_RTOL = 1e-5
KEY_GAP = 1e-5               # picks compared where both neighbours are apart
# raster kernels against the plain version (tests/test_torch_raster_cuda.py)
RASTER_KERNEL_ATOL = {"attr": 1e-6, "depth": 0.0, "silhouette": 1e-5}
RASTER_GRAD_RTOL = 1e-4
# an NVIDIA H100 SXM's published peaks at 700 W: float32 outside the tensor
# cores, and HBM3
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# operations per (pixel, slot) pair: three edge functions (15), the
# silhouette's distance and logit (7) and its log(1 - sigmoid) term (8),
# counting a transcendental as one; the backward recomputes them and adds
# the chain rule to six coordinates
FWD_OPS_PER_PAIR = 30
BWD_OPS_PER_PAIR = 60
# the kNN per (point, vertex) pair: 8 flops of |v|^2 - 2 p.v (a depth-4
# product) on the tensor cores at the TF32 peak and one compare at the
# float32 instruction rate (half the float32 flop rate); the scalar
# kernel's yardstick, 8 float32 operations at FP32_PEAK, is printed beside
# it
KNN_FLOPS_PER_PAIR = 8
TF32_PEAK = 495e12
FP32_INSTR_RATE = 33.5e12
# the full-width fit frame: image size, body subdivision, marching res
FIT_SIZE, FIT_SUBDIV, FIT_RES = 512, 5, 256
# the demo CLI's artifacts per photo (the JAX CLI's set, tests/
# test_infer_e2e.py:57-67, and the later stages' meshes)
CLI_ARTIFACTS = ("_smpl.obj", "_smpl.npy", "_smpl.gif", "_overlap.png",
                 "_recon.obj", "_refine.obj", "_recon_color.obj")
HPS_RTOL = 1e-3
# YOLO, U^2-Net and PARE on the card against the CPU (phase 11): the max
# error over each array's largest magnitude, TF32 off
NET_RTOL = 1e-4
IK_DET_TOL = 1e-3
# phase 13: PaMIR's volume (the config's default resolution); the splat's
# tolerance: two summation orders of a voxel's m non-negative terms differ by
# at most 2 m 2^-24 of its sum
VOXEL_RES = 128
ORDER_EPS = 2.0 ** -24
# float32 operations of the splat per vertex: its voxel coordinates (15) and
# per corner three differences, two weight products, three code products and
# four atomic adds (12)
SPLAT_OPS_PER_VERTEX = 15 + 8 * 12
VOXEL_REPLACES = {"voxel_splat": "icon_tpu/ops/voxelize.py:80",
                  "box_smooth3d": "icon_tpu/ops/voxelize.py:107"}
# the voxelize kernels alone in their previous design (one thread a vertex
# with 32 scalar atomics; three smooth passes), ms on one NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6, "Before")
VOXEL_BEFORE_MS = {"voxel_splat": (0.1054, 0.1012),
                "box_smooth3d": (0.1919, 0.1925)}
# the splat's stress input: vertices of the 8,000 at the padding point
VOXEL_STRESS_PADS = 7358
# the JAX package's level counts for the pamir frame (its own network at the
# same widths, the variant field, the subdiv-5 body, res 256; see
# CHANGES.md): the variant field's, the net's preds * 1e-6 term moves no
# voxel across 0.5
JAX_PAMIR_LEVEL1_POINTS = JAX_VARIANT_LEVEL1_POINTS
JAX_PAMIR_LEVEL2_POINTS = JAX_VARIANT_LEVEL2_POINTS


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


def kernel_ms(launch, reps: int = 20) -> float:
    """Median over 5 runs of the CUDA-event time per launch of ``reps``
    back-to-back ``launch()`` calls, queued behind a device sleep so that
    the host's dispatch does not reach the timed window."""
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


def bound(n_bytes: float, ops: float):
    """(least time in ms, "bytes" or "operations") for moving ``n_bytes``
    once and doing ``ops`` float32 operations on one H100."""
    t_bytes, t_ops = n_bytes / HBM_RATE, ops / FP32_PEAK
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def knn_hmma(lib: str) -> None:
    """Fail unless the kNN kernel's SASS holds HMMA (tensor-core)
    instructions; print their count and the first."""
    import os.path as osp
    from icon_tpu_torch.kernels.build import find_nvcc
    cuobjdump = osp.join(osp.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    fn, hmma = "", []
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HMMA" in line and "knn_kernel" in fn:
            hmma.append((fn, line.split(";")[0].split("*/")[-1].strip()))
    if not hmma:
        raise AssertionError("no HMMA instruction in the kNN kernel's SASS")
    print(f"[2] knn.cu SASS: {len(hmma)} HMMA instructions in the knn_kernel "
          f"instances; first: {hmma[0][1]} in {hmma[0][0]}", flush=True)


def level0_points(res0: int, device) -> torch.Tensor:
    """The engine's level-0 lattice (``res0``^3) as world points [1, N, 3]."""
    g = torch.linspace(0.0, 1.0, res0, device=device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([xx, yy, zz], -1).reshape(1, -1, 3) * \
        torch.tensor([2.0, -2.0, 2.0], device=device) + \
        torch.tensor([-1.0, 1.0, -1.0], device=device)


def knn_bound(n: int, v: int, k: int):
    """(least time in ms, "bytes" or "operations") of the kNN at [n, 3] x
    [v, 3] -> [n, k] on one H100: the larger of its bytes over the memory
    rate, its products over the TF32 peak and its compares over the float32
    instruction rate."""
    t_bytes = 4.0 * (3 * n + 3 * v + 2 * k * n) / HBM_RATE
    t_ops = max(KNN_FLOPS_PER_PAIR * n * v / TF32_PEAK,
                n * v / FP32_INSTR_RATE)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def knn_picks_agree(idx, key, pts, verts, k):
    """(max relative key error, whether every pick equals the plain
    version's wherever the plain keys on both sides of it, the (k+1)-th
    included, are more than KEY_GAP apart, share of such picks, plain idx,
    plain key)."""
    from icon_tpu_torch.kernels import knn
    idx0, key0 = knn.nearest_vertices_plain(pts, verts, k)
    rel = float(((key - key0).abs() / key0.abs().clamp(min=1.0)).max())
    vn = knn.squared_norms(verts)[None]
    after = torch.cat([(vn - 2.0 * (p @ verts.T)).topk(
        k + 1, 1, largest=False).values[:, k:] for p in pts.split(16384)])
    keys = torch.cat([torch.full_like(after, -float("inf")), key0, after], 1)
    gaps = torch.diff(keys, dim=1)
    clear = (gaps[:, :k] > KEY_GAP) & (gaps[:, 1:] > KEY_GAP)
    same = bool((idx[clear] == idx0[clear]).all())
    return rel, same, float(clear.float().mean()), idx0, key0


def phase_knn(dev, verts_np, buckets):
    """Kernel vs plain at the main path's shapes: the level-0 lattice, the
    engine's level-1 and level-2 buckets (``buckets``) and the cap; returns
    the summary entry."""
    from icon_tpu_torch.kernels import knn
    rng = np.random.RandomState(0)
    verts = torch.from_numpy(verts_np).to(dev)
    v = len(verts_np)

    def near(n):         # within 2 cm of the surface, like boundary queries
        d = rng.normal(size=(n, 3))
        d *= (0.02 * rng.uniform(0, 1, (n, 1)) ** (1 / 3)
              / np.linalg.norm(d, axis=1, keepdims=True))
        return verts_np[rng.randint(0, v, n)] + d

    lattice = level0_points(33, dev)[0].contiguous()
    cases = [("level 0 lattice", lattice, 2)]
    cases += [(f"level {lv} bucket near", near(n), 2)
              for lv, n in sorted(buckets.items())]
    cases += [("cap near", near(KNN_CAP), 2),
              ("cap cube", rng.uniform(-1, 1, (KNN_CAP, 3)), 2),
              ("k=8 cube", rng.uniform(-1, 1, (4096, 3)), 8)]
    worst, timing = 0.0, {}
    for name, pts, k in cases:
        if not torch.is_tensor(pts):
            pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
        n = len(pts)
        idx, key = knn.nearest_vertices_kernel(pts, verts, k)
        torch.cuda.synchronize()
        rel, same, share, idx0, key0 = knn_picks_agree(idx, key, pts, verts,
                                                       k)
        ties = ""
        if name == "level 0 lattice":      # the mirror body ties exactly
            n_diff = int((idx != idx0).any(1).sum())
            ties = f", rows whose idx differ {n_diff}"
            same = same and n_diff == 0
        err = float((key - key0).abs().max())
        out_i, out_k = torch.empty_like(idx), torch.empty_like(key)
        ms = kernel_ms(lambda: knn._launch(pts, verts, out_i, out_k))
        call_ms = cuda_ms(lambda: knn.nearest_vertices_kernel(pts, verts, k))
        plain_ms = cuda_ms(lambda: knn.nearest_vertices_plain(pts, verts, k),
                           reps=3)
        b_ms, b_by = knn_bound(n, v, k)
        old_ms, _ = bound(4.0 * (3 * n + 3 * v + 2 * k * n),
                          KNN_FLOPS_PER_PAIR * n * v)
        print(f"[3] knn {name} N={n} V={v} k={k}: max|dkey| {err:.3g} (rel "
              f"{rel:.3g}), every pick equal where gaps>{KEY_GAP:g}: {same} "
              f"({share:.1%} of picks){ties}; kernel alone {ms:.4f} ms, "
              f"whole call {call_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it (float32-only "
              f"bound {old_ms:.4f} ms, {old_ms / ms:.1%})",
              flush=True)
        if rel > KEY_RTOL or not same:
            raise AssertionError(f"knn kernel disagrees with plain: {name}")
        worst = max(worst, err)
        timing[name] = (ms, plain_ms, b_ms, b_by, pts)
    ms, plain_ms, b_ms, b_by, big = timing["cap near"]
    lib_ms = cuda_ms(lambda: torch.cdist(big, verts).topk(
        2, largest=False), reps=5)
    print(f"[3] knn cap N={KNN_CAP} k=2 near: kernel alone {ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), torch.cdist + topk {lib_ms:.4f} ms",
          flush=True)
    return {"name": "knn_f32", "route": "cuda",
            "source": "icon_tpu_torch/csrc/knn.cu",
            "replaces": "icon_tpu/ops/pallas/knn.py:60",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


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
            raw = fr.net_occ(level0_points(fr.engine.resolutions[0], device),
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
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=512, n_samples=64, subdiv=5)
    t0 = time.perf_counter()
    fr = build_frame(cfg, seeded_state(cfg, 0), batch, 256, dev)
    setup_s = time.perf_counter() - t0

    reset_launches()                  # count only the main path's launches
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fr.frame()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        stats, mesh, verts, faces = fr.frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launched = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    _, counts = fr.columns()
    n_over = int((counts > 32).sum())
    l1, l2 = int(stats["level1_points"]), int(stats["level2_points"])
    ov = [int(stats[k]) for k in sorted(stats) if k.endswith("_overflow")]
    print(f"[4] full frame: level1 {l1} (JAX {JAX_LEVEL1_POINTS}), level2 "
          f"{l2} (JAX {JAX_LEVEL2_POINTS}), n_tris {len(faces)} (JAX "
          f"{JAX_N_TRIS}), n_verts {len(verts)}, overflow {ov}, buckets "
          f"{fr.engine._bucket_used}, columns over 32: {n_over}, launches "
          f"{launched}, peak {peak_gb:.2f} GiB, setup "
          f"{setup_s:.2f} s", flush=True)
    print(f"[4] latency per frame (s): median {statistics.median(times):.4f} "
          f"all {[round(x, 4) for x in times]} on {card}, TF32 off",
          flush=True)
    if len(faces) == 0 or not np.isfinite(verts).all():
        raise AssertionError("empty or non-finite mesh")
    if n_over:
        raise AssertionError(f"{n_over} columns exceed 32 crossings")
    check_launched(launched, ("knn_f32",), "the frame")
    if any(ov):
        raise AssertionError(f"engine budget overflow {ov}")
    for name, got, ref in (("level1_points", l1, JAX_LEVEL1_POINTS),
                           ("level2_points", l2, JAX_LEVEL2_POINTS),
                           ("n_tris", len(faces), JAX_N_TRIS)):
        if abs(got - ref) > COUNT_RTOL * ref:
            raise AssertionError(f"{name} {got} vs JAX {ref}")
    return launched, dict(fr.engine._bucket_used)


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
            raw = fr.net_occ(level0_points(fr.engine.resolutions[0], device),
                             smpl, feats)
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

    reset_launches()                  # count only the main path's launches
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fr.frame()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        stats, mesh, verts, faces = fr.frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launched = read_launches()
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
          f"over {int(mask.sum())} px, launches {launched}, peak "
          f"{peak_gb:.2f} GiB, setup {setup_s:.2f} s", flush=True)
    print(f"[6] latency per frame (s): median {statistics.median(times):.4f} "
          f"all {[round(x, 4) for x in times]} on {card}, TF32 off",
          flush=True)
    if len(faces) == 0 or not np.isfinite(verts).all():
        raise AssertionError("empty or non-finite mesh")
    if n_over:
        raise AssertionError(f"{n_over} columns exceed 32 crossings")
    check_launched(launched, ("knn_f32", "raster_setup", "raster_bin",
                              "raster_fwd"), "the NormalNet frame")
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
    return launched


def compare_bins(ndc, faces, size, K):
    """raster_setup and raster_bin against the plain version on the card:
    the setup's pixel coordinates and depths, and every slot of the face
    lists, the counts and the overflow, identical. Returns (setup error,
    bin error, busy tiles, sum of the counts)."""
    from icon_tpu_torch.kernels import raster as rk
    f = faces.long().contiguous()
    slot, lists, counts, overflow, _ = rk._bin_kernel(
        ndc.detach().contiguous(), f, size, size, K)
    ref = rk.bin_faces_plain(ndc, f, size, size, K=K)
    xy = rk.pixel_xy(ndc.detach(), size, size)[f].reshape(-1, 6)
    got = torch.cat([slot[0], slot[1, :, :2]], 1)
    setup_err = max(float((got - xy).abs().max()),
                    float((slot[4, :, :3] - ndc[:, 2][f]).abs().max()))
    bin_err = max(float((lists.long() - ref[0]).abs().max()),
                  float((counts.long() - ref[1]).abs().max()),
                  float(abs(int(overflow) - int(ref[2]))))
    if setup_err or bin_err:
        raise AssertionError(f"raster_setup/raster_bin disagree with the "
                             f"plain binning: {setup_err}, {bin_err}")
    return setup_err, bin_err, int((counts > 0).sum()), int(counts.sum())


def compare_raster(tag, name, ndc, faces, attrs, size, K, rng,
                   backward: bool = True):
    """The raster kernels against the plain version on the card for one
    input: the setup and the bin lists identical (:func:`compare_bins`),
    pix_to_face identical on every pixel, attr, depth and silhouette within
    RASTER_KERNEL_ATOL, the same bin_overflow, and the gradients of a
    seeded weighted sum of the images within RASTER_GRAD_RTOL of their
    largest. Returns ({kernel: worst error}, bin_overflow, ``run(fn,
    grad)``: one call of ``rasterize`` or ``rasterize_plain`` on this
    input, with (loss, ndc, attrs) when ``grad``)."""
    from icon_tpu_torch.ops.raster import rasterize, rasterize_plain
    C = attrs.shape[1]
    setup_err, bin_err, busy, pairs = compare_bins(ndc, faces, size, K)
    weights = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        ndc.device) for shape in ((size, size, C), (size, size), (size, size))]

    def run(fn, grad: bool):
        x = ndc.detach().clone().requires_grad_(grad)
        a = attrs.detach().clone().requires_grad_(grad)
        out = fn(x, faces, a, H=size, W=size, K=K)
        if not grad:
            return out, None
        loss = (out.attr * weights[0]).sum() + \
            (out.depth * out.mask * weights[1]).sum() + \
            (out.silhouette * weights[2]).sum()
        return out, (loss, x, a)

    with torch.no_grad():
        out, _ = run(rasterize, False)
        ref, _ = run(rasterize_plain, False)
    torch.cuda.synchronize()
    differ = int((out.pix_to_face != ref.pix_to_face).sum())
    errs = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
            for k in RASTER_KERNEL_ATOL}
    grad_err, grad_rel = 0.0, 0.0
    if backward:
        grads = []
        for fn in (rasterize, rasterize_plain):
            _, (loss, x, a) = run(fn, True)
            grads.append(torch.autograd.grad(loss, (x, a)))
        for g, w in zip(*grads):
            d = float((g - w).abs().max())
            grad_err = max(grad_err, d)
            grad_rel = max(grad_rel, d / max(float(w.abs().max()), 1e-30))
    print(f"{tag} {name}: setup and bin lists identical ({busy} busy tiles,"
          f" {pairs} slots); pix_to_face differs at {differ} of "
          f"{size * size} px ({int((ref.pix_to_face >= 0).sum())} covered), "
          f"max|d| "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + (f"; grads max|d| {grad_err:.3g} ({grad_rel:.3g} of the "
             f"largest)" if backward else "; forward only")
          + f"; bin_overflow {int(out.bin_overflow)}", flush=True)
    if differ or any(errs[k] > tol for k, tol in RASTER_KERNEL_ATOL.items()) \
            or grad_rel > RASTER_GRAD_RTOL or \
            int(out.bin_overflow) != int(ref.bin_overflow):
        raise AssertionError(f"{name}: the raster kernels disagree with the "
                             f"plain version")
    errors = {"raster_setup": setup_err, "raster_bin": bin_err,
              "raster_fwd": max(errs.values()), "raster_bwd": grad_err}
    return errors, int(out.bin_overflow), run


RASTER_REPLACES = {"raster_setup": "icon_tpu/ops/raster.py:106",
                   "raster_bin": "icon_tpu/ops/raster.py:49",
                   "raster_fwd": "icon_tpu/ops/raster.py:123",
                   "raster_bwd": "icon_tpu/ops/raster.py:123"}


def raster_kernel_times(ndc, faces, attrs, size, K, weights):
    """Each raster kernel alone on this input (:func:`kernel_ms` of its
    launches on preallocated buffers), the plain version of the same step
    (the per-face gathers, ``_bin_faces``, ``raster_plain`` forward), and
    each kernel's bound on this input's busy tiles. Returns {kernel: (ms,
    plain ms or None, bound ms, bound by)}."""
    from icon_tpu_torch.kernels import raster as rk
    lib = rk._load()
    dev = ndc.device
    f = faces.long().contiguous()
    ndc = ndc.detach().contiguous()
    attrs = attrs.detach().contiguous()
    F, V, C = f.shape[0], ndc.shape[0], attrs.shape[1]
    tiles = (size + rk.TILE - 1) // rk.TILE
    n_tiles = tiles * tiles
    S, R = rk.splits(n_tiles, K)
    kz = rk._sil_constant(size, size, 1e-4)
    slot, lists, counts, overflow, tile_done = rk._bin_kernel(
        ndc, f, size, size, K)
    n_chunks = -(-F // rk.CHUNK)
    box = torch.empty((F, 4), dtype=torch.int32, device=dev)
    chunk = torch.empty((n_chunks, 4), dtype=torch.int32, device=dev)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    attr = empty((size, size, C))
    depth, mask, sil, logsum = (empty((size, size)) for _ in range(4))
    p2f = empty((size, size), torch.int64)
    win = empty((size, size), torch.int32)
    n = n_tiles * S * rk.TILE * rk.TILE
    part = (empty((n,)), empty((n,), torch.int32), empty((n,)))
    g_attr, g_depth, g_sil = (w.contiguous() for w in weights)
    gv, ga = empty((V, 3)).zero_(), empty((V, C)).zero_()
    stream = torch.cuda.current_stream().cuda_stream

    def P(t):
        return t.data_ptr()

    def check(err, name):
        if err:
            raise RuntimeError(f"{name} launch failed ({err})")

    def setup():
        check(lib.icon_raster_setup(P(ndc), P(f), F, size, size, P(slot),
                                    P(box), P(chunk), P(tile_done),
                                    P(overflow), stream), "raster_setup")

    def binning():
        check(lib.icon_raster_bin(P(box), P(chunk), F, size, size, K,
                                  P(lists), P(counts), P(overflow), stream),
              "raster_bin")

    def fwd():
        check(lib.icon_raster_fwd(
            P(lists), P(counts), P(slot), F, P(f), P(attrs), K, R, S, C,
            size, size, kz, *map(P, part), P(tile_done), P(attr), P(depth),
            P(mask), P(sil), P(p2f), P(win), P(logsum), stream),
            "raster_fwd")

    def bwd():
        check(lib.icon_raster_bwd(
            P(lists), P(counts), P(slot), F, P(f), P(attrs), K, R, S, C,
            size, size, kz, P(g_attr), P(g_depth), P(g_sil), P(win),
            P(logsum), P(gv), P(ga), stream), "raster_bwd")

    ms = {"raster_setup": kernel_ms(setup), "raster_bin": kernel_ms(binning),
          "raster_fwd": kernel_ms(fwd), "raster_bwd": kernel_ms(bwd)}

    tri_xy = rk.pixel_xy(ndc, size, size)[f]
    tri_z, tri_attr = ndc[:, 2][f], attrs[f]
    fl, cn, _ = rk._bin_faces(tri_xy, tiles, tiles, rk.TILE, size, size, K)
    plain = {
        "raster_setup": cuda_ms(lambda: (rk.pixel_xy(ndc, size, size)[f],
                                         ndc[:, 2][f], attrs[f])),
        "raster_bin": cuda_ms(lambda: rk._bin_faces(
            tri_xy, tiles, tiles, rk.TILE, size, size, K)),
        "raster_fwd": cuda_ms(lambda: rk.raster_plain(
            tri_xy, tri_z, tri_attr, fl, cn, size, size, rk.TILE, 1e-4, 16)),
        "raster_bwd": None}

    slots = int(counts.sum())               # (tile, face) pairs listed
    pairs = slots * rk.TILE * rk.TILE
    image = size * size
    need = {
        "raster_setup": (V * 12 + F * 24 + F * (16 * rk.SLOT_FIELDS + 16)
                         + n_chunks * 16 + n_tiles * 4 + 8, F * 40),
        "raster_bin": (F * 16 + n_chunks * 16 + n_tiles * (K + 1) * 4 + 8,
                       slots),
        "raster_fwd": (slots * (16 * rk.SLOT_FIELDS + 4)
                       + n_tiles * (K + 1) * 4 + image * (4 * C + 28),
                       pairs * FWD_OPS_PER_PAIR),
        "raster_bwd": (slots * (16 * rk.SLOT_FIELDS + 4)
                       + image * (4 * C + 16) + V * (12 + 4 * C),
                       pairs * BWD_OPS_PER_PAIR)}
    return {k: (ms[k], plain[k], *bound(*need[k])) for k in ms}


def phase_raster_kernels(dev, verts_np, faces_np):
    """The raster kernels against the plain version on the card at the
    demo's shapes, each kernel timed alone and the whole calls timed;
    returns their summary entries (at the renders' and the cloth loop's
    shape, 512^2 with K=256)."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    from icon_tpu_torch.ops.raster import rasterize, rasterize_plain
    from icon_tpu_torch.render.camera import verts_to_ndc

    v = torch.from_numpy(verts_np).to(dev)
    f = torch.from_numpy(faces_np).long().to(dev)
    rng = np.random.RandomState(7)
    cases = [(f"render_normal 512^2 K={k}", 512, k, 3) for k in (256, 96)]
    cases.append(("vertex_visibility 1024^2 K=512", 1024, 512, 1))
    worst = dict.fromkeys(RASTER_REPLACES, 0.0)
    timing = {}
    for name, size, K, C in cases:
        # the renders' own inputs: the vertex normals (the view frame at
        # azimuth 0), or the visibility raster's zero attribute
        ndc = verts_to_ndc(v, 0.0)
        attrs = vertex_normals(v[None], f)[0] if C == 3 else \
            v.new_zeros((len(v), 1))
        errs, _, run = compare_raster("[7]", name, ndc, f, attrs, size, K,
                                      rng)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)

        def fwd(fn):
            with torch.no_grad():
                run(fn, False)

        def bwd_of(fn):
            _, (loss, x, a) = run(fn, True)
            return lambda: torch.autograd.grad(loss, (x, a),
                                               retain_graph=True)

        weights = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev) for shape in ((size, size, C), (size, size), (size, size))]
        kern = raster_kernel_times(ndc, f, attrs, size, K, weights)
        call = {"fwd": cuda_ms(lambda: fwd(rasterize)),
                "plain_fwd": cuda_ms(lambda: fwd(rasterize_plain)),
                "bwd": cuda_ms(bwd_of(rasterize)),
                "plain_bwd": cuda_ms(bwd_of(rasterize_plain))}
        kern["raster_bwd"] = kern["raster_bwd"][:1] + (call["plain_bwd"],) + \
            kern["raster_bwd"][2:]
        timing[(size, K)] = kern
        print(f"[7] {name}: whole call forward {call['fwd']:.4f} ms (plain "
              f"{call['plain_fwd']:.4f}), backward {call['bwd']:.4f} ms "
              f"(plain {call['plain_bwd']:.4f}); kernels alone: " + "; ".join(
                  f"{k} {m:.4f} ms (plain "
                  + ("n/a" if p is None else f"{p:.4f}")
                  + f", bound {b:.4f} ms by {by}, {b / m:.1%} of it)"
                  for k, (m, p, b, by) in kern.items()), flush=True)
    return [{"name": name, "route": "cuda",
             "source": "icon_tpu_torch/csrc/raster.cu",
             "replaces": RASTER_REPLACES[name], "max_abs_err": worst[name],
             "ms": m, "plain_ms": p, "bound_ms": b, "bound_by": by,
             "library_ms": None}
            for name, (m, p, b, by) in timing[(512, 256)].items()]


def fit_on(fit, device):
    """An ``SmplFit`` moved to ``device``."""
    from icon_tpu_torch.infer.refine import SmplFit
    return SmplFit(fit.verts.to(device),
                   tuple(n.to(device) for n in fit.normals), fit.losses,
                   {k: v.to(device) for k, v in fit.params.items()})


def phase_small_fit_frame(dev):
    """The fit frame at image 64^2, res 128, the subdiv-3 SMPL-X-layout
    body, bench.py's config with the published NormalNet widths and its
    variant field, 3 fit and 2 cloth iterations, on the card vs on the CPU:
    fit losses to 1e-3 relative (cuDNN against the CPU's convolutions
    through the NormalNet), level counts and marched triangles equal. Then
    the card's recon chain and cloth loop from the CPU's fitted body and
    remeshed mesh (the host remesh follows edge lengths, so a marched vertex
    one u8 step apart changes its output): raw net occupancy at the level-0
    points to 1e-4, cloth losses to 1e-3 relative."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.engine import reconstruction_resolutions
    from icon_tpu_torch.recon.frame import (bench_config, build_fit_frame,
                                            seeded_state, variant_occ)
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    cfg = bench_config()
    state = seeded_state(cfg, 1, normal_net=True)
    item = synthetic_fit_item(synthetic_smplx_model(subdiv=3), 64, seed=1)
    frames, out = {}, {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        frames[name] = build_fit_frame(
            cfg, state, synthetic_smplx_model(subdiv=3), 128, device,
            loop_smpl=3, loop_cloth=2, field=variant_occ)
        out[name] = frames[name].frame(item)
    c, g = out["cpu"], out["gpu"]
    rel = float(np.max(np.abs(np.subtract(c.fit.losses, g.fit.losses)) /
                       np.abs(c.fit.losses)))
    counts = [(int(r.stats["level1_points"]), len(r.recon[1]),
               len(r.remeshed[1])) for r in (c, g)]

    res0 = reconstruction_resolutions(128)[0]
    raw = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        calib = torch.from_numpy(item["calib"]).to(device)
        smpl, feats = frames[name].prep(
            torch.from_numpy(item["image"]).to(device),
            fit_on(c.fit, device), calib)
        with torch.no_grad():
            raw[name] = frames[name].net_occ(
                level0_points(res0, device), smpl, feats,
                calib).cpu().numpy()
    occ_err = float(np.abs(raw["cpu"] - raw["gpu"]).max())
    _, closses = frames["gpu"].cloth(*c.remeshed, fit_on(c.fit, dev))
    cloth_rel = float(np.max(np.abs(np.subtract(closses, c.cloth_losses)) /
                             np.abs(c.cloth_losses)))
    print(f"[8] small fit frame, card vs CPU: fit losses {g.fit.losses} vs "
          f"{c.fit.losses} (max rel {rel:.3g}); level1, marched, remeshed "
          f"triangles {counts[1]} vs {counts[0]}; from the CPU's fitted body:"
          f" raw occupancy max|d| {occ_err:.3g} (std {raw['cpu'].std():.3g})"
          f"; from the CPU's remeshed mesh: cloth losses {closses} vs "
          f"{c.cloth_losses} (max rel {cloth_rel:.3g})", flush=True)
    if rel > 1e-3 or counts[0][:2] != counts[1][:2] or \
            not np.isfinite(g.cloth_losses).all() or \
            not bool(torch.isfinite(g.verts).all()) or counts[1][2] < 1000 \
            or not occ_err <= 1e-4 or not raw["cpu"].std() > 0 or \
            not cloth_rel <= 1e-3:
        raise AssertionError("small fit frame on the card disagrees with "
                             "the CPU")


def phase_full_fit_frame(dev, card):
    """The fit frame at full width, stage by stage (the composition of
    ``FitFrame.frame``), with a synchronize between stages; then the raster
    kernels against the plain version on the frame's own meshes, and a
    known-answer fit. Returns (launches, worst raster errors)."""
    from icon_tpu_torch.infer.refine import refine_smpl
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import (bench_config, build_fit_frame,
                                            seeded_state, variant_occ)
    from icon_tpu_torch.render.camera import verts_to_ndc
    from icon_tpu_torch.render.render import (render_normal,
                                              render_silhouette)
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    cfg = bench_config()
    body = synthetic_smplx_model(subdiv=FIT_SUBDIV)
    size = FIT_SIZE
    t0 = time.perf_counter()
    fr = build_fit_frame(cfg, seeded_state(cfg, 0, normal_net=True), body,
                         FIT_RES, dev, field=variant_occ)
    item = synthetic_fit_item(fr.body, size, seed=0)
    image = torch.from_numpy(item["image"]).to(dev)
    calib = torch.from_numpy(item["calib"]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset_launches()                  # count only the main path's launches
    torch.cuda.reset_peak_memory_stats()
    stage = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stage[name] = time.perf_counter() - t
        return out

    fit = timed("fit", fr.fit, item)
    verts, faces, stats = timed("recon", fr.recon, image, fit, calib)
    rverts, rfaces = timed("remesh", fr.remesh, verts, faces)
    refined, closses = timed("cloth", fr.cloth, rverts, rfaces, fit)
    faces_t = torch.as_tensor(rfaces, device=dev)
    colors = timed("color", fr.color, refined, faces_t, image)
    launched = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    n_fit, n_cloth = len(fit.losses), len(closses)
    l1, l2 = int(stats["level1_points"]), int(stats["level2_points"])
    print(f"[9] full fit frame: fit {fit.losses[0]:.6f} -> "
          f"{fit.losses[-1]:.6f} ({n_fit} iterations, "
          f"{stage['fit'] / n_fit:.4f} s/iteration); recon "
          f"{stage['recon']:.3f} s (level1 {l1}, level2 {l2}, marched "
          f"{len(verts)} verts / {len(faces)} tris after clean_mesh); remesh "
          f"{stage['remesh']:.3f} s host ({len(rverts)} verts / "
          f"{len(rfaces)} tris); cloth {closses[0]:.6f} -> {closses[-1]:.6f} "
          f"({n_cloth} iterations, {stage['cloth'] / n_cloth:.4f} "
          f"s/iteration); colour {stage['color']:.3f} s", flush=True)
    print(f"[9] launches {launched}; peak "
          f"{peak_gb:.2f} GiB; setup {setup_s:.2f} s; total "
          f"{sum(stage.values()):.3f} s on {card}, TF32 off", flush=True)
    check_launched(launched, ("knn_f32", *RASTER_REPLACES), "the fit frame")
    if not (np.isfinite(fit.losses).all() and np.isfinite(closses).all()
            and bool(torch.isfinite(refined).all())
            and bool(torch.isfinite(colors).all())):
        raise AssertionError("non-finite losses, vertices or colours")
    if len(rfaces) < 10000 or colors.shape != refined.shape:
        raise AssertionError("the fit frame's mesh is too small")
    for name, got, ref in (("level1_points", l1, JAX_VARIANT_LEVEL1_POINTS),
                           ("level2_points", l2, JAX_VARIANT_LEVEL2_POINTS)):
        if abs(got - ref) > COUNT_RTOL * ref:
            raise AssertionError(f"{name} {got} vs JAX {ref}")

    # the raster kernels against the plain version on the frame's meshes,
    # with the rasters' bin lists and overflow: the fit's (K=96, the fitted
    # body), the cloth loop's (K=256: its first input, the remeshed mesh,
    # at azimuth 0, and its output at 180), the remeshed mesh at 1024^2 with
    # K=512 and the colour stage's visibility raster (K=512 at 1024^2, the
    # refined mesh); the 1024^2 ones forward only
    bf = torch.as_tensor(np.asarray(body.faces), dtype=torch.int64,
                         device=dev)
    rv = torch.as_tensor(rverts, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(11)
    overflow, worst = {}, dict.fromkeys(RASTER_REPLACES, 0.0)
    for name, (ndc, f, attrs), res, K in (
            ("fit K=96", normal_inputs(fit.verts, bf, 0.0), size, 96),
            ("cloth K=256 az 0", normal_inputs(rv, faces_t, 0.0), size, 256),
            ("cloth K=256 az 180", normal_inputs(refined, faces_t, 180.0),
             size, 256),
            ("remeshed K=512", (verts_to_ndc(rv), faces_t,
                                rv.new_zeros((len(rv), 1))), 1024, 512),
            ("vis K=512", (verts_to_ndc(refined), faces_t,
                           refined.new_zeros((len(refined), 1))), 1024,
             512)):
        errs, overflow[name], _ = compare_raster(
            "[9]", f"{name} {res}^2", ndc, f, attrs, res, K, rng,
            backward=K != 512)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
    print(f"[9] bin_overflow {overflow}", flush=True)

    # known answer: Adam (at the demo's fit learning rate) on the body's
    # betas, pose, orientation and translation toward its own renders at
    # seeded target betas
    rng = np.random.RandomState(3)
    target = torch.from_numpy((rng.randn(1, 10) * 0.8).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        tv = fr.body(betas=target)[0][0]
        goals = (render_normal(tv, bf, size, 0.0)[0],
                 render_normal(tv, bf, size, 180.0)[0],
                 render_silhouette(tv, bf, size, 0.0))
    init = {"betas": np.zeros((1, 10), np.float32),
            "body_pose": np.zeros((1, 63), np.float32),
            "global_orient": np.zeros((1, 3), np.float32),
            "trans": np.zeros((1, 3), np.float32)}
    t0 = time.perf_counter()
    _, _, klosses = refine_smpl(fr.body, bf, init, *goals, iters=30,
                                lr=1e-3, size=size)
    print(f"[9] known answer: refine_smpl toward the body's render at seeded "
          f"betas: {klosses[0]:.6f} -> {klosses[-1]:.6f} (min "
          f"{min(klosses):.6f}) in 30 iterations, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not np.isfinite(klosses).all() or not klosses[-1] < klosses[0]:
        raise AssertionError("the known-answer fit did not lower its loss")
    return launched, worst


def phase_cli(dev, card):
    """The demo CLI on the card from two photos at full width; then the
    kernels of its path against their plain versions on what the run gave
    them. The kNN: every call of the run, recorded (a pass-through spy on
    ``sdf_fast``'s kNN wrapper that clones the inputs and counts nothing:
    the recon engine's level points against the padded fitted body). The
    raster kernels, per photo, on the run's meshes, with their bin lists
    and overflow: the fitted body at K=96 (the fit), the recon at azimuth 0
    and the refined mesh at 180 with K=256 (the cloth loop's input and
    output), and at 1024^2 with K=512 the recon's visibility raster of the
    fitted body and the colour stage's of the refined mesh. Returns (the
    launches of the CLI's run, {kernel: worst error})."""
    import os
    import tempfile
    from icon_tpu_torch.apps.infer import main
    from icon_tpu_torch.data.test_dataset import TestDataset
    from icon_tpu_torch.recon.frame import bench_config
    from icon_tpu_torch.utils.synthetic import write_demo_inputs

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_demo_inputs(d, bench_config(), hps_ckpt=True)
        inputs_s = time.perf_counter() - t0
        # PyMAF on the card against the CPU on the same photos
        items = {}
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            ds = TestDataset(paths["in_dir"], hps_ckpt=paths["hps_ckpt"],
                             icon_size=FIT_SIZE, device=device)
            items[name] = [ds[i] for i in range(len(ds))]
        hps_err = 0.0
        for c, g in zip(items["cpu"], items["gpu"]):
            for k in ("betas", "body_pose", "global_orient", "smpl_verts",
                      "trans"):
                ref = np.abs(c[k]).max()
                hps_err = max(hps_err, float(np.abs(g[k] - c[k]).max()) /
                              max(float(ref), 1e-6))
            hps_err = max(hps_err, abs(g["scale"] - c["scale"]) /
                          abs(c["scale"]))
        scales = [round(it["scale"], 4) for it in items["gpu"]]
        print(f"[10] PyMAF on the card vs the CPU (2 photos): max error "
              f"{hps_err:.3g} of each array's largest magnitude; scales "
              f"{scales}; inputs written in {inputs_s:.2f} s", flush=True)
        if not hps_err <= HPS_RTOL:
            raise AssertionError("PyMAF on the card disagrees with the CPU")

        argv = ["-cfg", paths["cfg"], "-in_dir", paths["in_dir"],
                "-out_dir", paths["out_dir"], "-ckpt", paths["ckpt"],
                "-normal_ckpt", paths["normal_ckpt"], "-hps_ckpt",
                paths["hps_ckpt"], "-loop_smpl", "100", "-loop_cloth", "200",
                "-no_remesh", "-allow_random_hps", "-img_size",
                str(FIT_SIZE), "-mcube_res", str(FIT_RES)]
        knn_calls = []
        torch.cuda.synchronize()
        remove_spy = knn_spy(knn_calls)
        reset_launches()              # count only the main path's launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            records = main(argv, device=dev, keep_meshes=True)
        finally:
            remove_spy()
        total_s = time.perf_counter() - t0
        launched = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        written = sorted(os.listdir(paths["out_dir"]))

    for r in records:
        st = r["stages"]
        n_fit, n_cloth = len(r["fit_losses"]), len(r["cloth_losses"])
        print(f"[10] {r['name']}: preprocess {st['preprocess']:.4f} s "
              f"(host), hps {st['hps']:.4f} s, fit {st['fit']:.3f} s "
              f"({st['fit'] / max(n_fit, 1):.4f} s/iteration, "
              f"{r['fit_losses'][0]:.5f} -> {r['fit_losses'][-1]:.5f}), "
              f"recon {st['recon']:.3f} s ({r['recon'][0]} verts / "
              f"{r['recon'][1]} tris, levels {r['stats']}), cloth "
              f"{st.get('cloth', 0.0):.3f} s "
              f"({st.get('cloth', 0.0) / max(n_cloth, 1):.4f} s/iteration), "
              f"colour {st['color']:.3f} s, writes {st['writes']:.3f} s"
              + (f", setup {st['setup']:.3f} s" if "setup" in st else ""),
              flush=True)
    print(f"[10] demo CLI: {len(records)} photos in {total_s:.2f} s, "
          f"launches {launched}, peak {peak_gb:.2f} GiB on {card}, TF32 off",
          flush=True)
    check_launched(launched, ("knn_f32", *RASTER_REPLACES), "the demo CLI")
    want = sorted(f"{r['name']}{s}" for r in records for s in CLI_ARTIFACTS)
    if len(records) != 2 or written != want:
        raise AssertionError(f"CLI artifacts {written}, want {want}")
    for r in records:
        if len(r["fit_losses"]) != 100 or len(r["cloth_losses"]) != 200 or \
                not np.isfinite(r["fit_losses"] + r["cloth_losses"]).all():
            raise AssertionError(f"{r['name']}: loops short or non-finite")
        if r["recon"][1] < 10000 or r["final"] != r["recon"]:
            raise AssertionError(f"{r['name']}: recon {r['recon']}")
        if any(v for k, v in r["stats"].items() if k.endswith("overflow")):
            raise AssertionError(f"{r['name']}: engine overflow {r['stats']}")

    return launched, cli_kernels_agree("[10]", records, knn_calls, launched,
                                       dev, seed=12)


def knn_spy(calls: list):
    """A pass-through spy on ``sdf_fast``'s kNN wrapper that records each
    call's inputs (cloned) in ``calls`` and counts nothing; returns a
    function that removes it."""
    from icon_tpu_torch.ops import sdf_fast
    kernel = sdf_fast.nearest_vertices_kernel

    def spy(points, verts, k):
        calls.append((points.detach().clone(), verts.detach().clone(), k))
        return kernel(points, verts, k)

    sdf_fast.nearest_vertices_kernel = spy

    def remove():
        sdf_fast.nearest_vertices_kernel = kernel
    return remove


def cli_kernels_agree(tag, records, knn_calls, launched, dev, seed):
    """The kernels of a CLI run against their plain versions on the run's
    own inputs: every recorded kNN call (keys, picks), and per photo the
    raster kernels on the fitted body at K=96 (the fit), the recon at
    azimuth 0 and the final mesh at 180 with K=256 (the cloth loop's input
    and output), and at 1024^2 with K=512 the recon's visibility raster of
    the fitted body and the colour stage's of the final mesh, with their
    bin lists and overflow. Returns {kernel: worst error}."""
    from icon_tpu_torch.data.render_dataset import make_calib
    from icon_tpu_torch.kernels import knn
    from icon_tpu_torch.ops.projection import project
    from icon_tpu_torch.render.camera import verts_to_ndc

    worst = dict.fromkeys(("knn_f32", *RASTER_REPLACES), 0.0)
    if len(knn_calls) != launched["knn_f32"]:
        raise AssertionError(f"{len(knn_calls)} kNN calls recorded, "
                             f"{launched['knn_f32']} launched")
    for i, (pts, verts, k) in enumerate(knn_calls):
        idx, key = knn.nearest_vertices_kernel(pts, verts, k)
        torch.cuda.synchronize()
        rel, same, share, _, key0 = knn_picks_agree(idx, key, pts, verts, k)
        err = float((key - key0).abs().max())
        print(f"{tag} knn call {i} N={len(pts)} V={len(verts)} k={k}: "
              f"max|dkey| {err:.3g} (rel {rel:.3g}), every pick equal where "
              f"gaps>{KEY_GAP:g}: {same} ({share:.1%} of picks)", flush=True)
        if rel > KEY_RTOL or not same:
            raise AssertionError(f"{tag} knn kernel disagrees with plain "
                                 f"on the CLI's call {i}")
        worst["knn_f32"] = max(worst["knn_f32"], err)
    calib8 = make_calib(0.0)            # the CLI's calib (apps/infer.py)
    calib = torch.as_tensor(calib8[4:8] @ calib8[:4], device=dev)
    rng = np.random.RandomState(seed)
    overflow = {}
    for r in records:
        (bv, bf), (cv, cf), (fv, ff) = (
            (torch.as_tensor(v, dtype=torch.float32, device=dev),
             torch.as_tensor(np.asarray(f), dtype=torch.int64, device=dev))
            for v, f in (r["meshes"][m] for m in ("body", "recon", "final")))
        for name, (ndc, f, attrs), res, K in (
                ("fit K=96", normal_inputs(bv, bf, 0.0), FIT_SIZE, 96),
                ("cloth K=256 az 0", normal_inputs(cv, cf, 0.0), FIT_SIZE,
                 256),
                ("cloth K=256 az 180", normal_inputs(fv, ff, 180.0),
                 FIT_SIZE, 256),
                ("recon vis K=512", (project(bv[None], calib[None])[0], bf,
                                     bv.new_zeros((len(bv), 1))), 1024, 512),
                ("colour vis K=512", (verts_to_ndc(fv), ff,
                                      fv.new_zeros((len(fv), 1))), 1024,
                 512)):
            name = f"{r['name']} {name}"
            errs, overflow[name], _ = compare_raster(
                tag, f"{name} {res}^2", ndc, f, attrs, res, K, rng,
                backward=K != 512)
            for k, e in errs.items():
                worst[k] = max(worst[k], e)
    print(f"{tag} bin_overflow {overflow}", flush=True)
    return worst


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (both moved to the CPU)."""
    got, want = (torch.as_tensor(x).detach().float().cpu()
                 for x in (got, want))
    return float((got - want).abs().max()) / \
        max(float(want.abs().max()), 1e-30)


def turntable_inputs(verts, faces, colors, azimuth, dev):
    """The turntable frame's raster inputs at ``azimuth``: the vertices
    rotated about y on the host in float32 and flipped to NDC by (1, -1,
    -1), as ``apps/infer.py:export_turntable_video`` and the JAX CLI do."""
    a = np.radians(azimuth)
    rot = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, 1.0, 0.0],
                    [np.sin(a), 0.0, np.cos(a)]], np.float32)
    v_rot = np.asarray(verts, np.float32) @ rot.T
    ndc = torch.from_numpy(v_rot).to(dev) * torch.tensor(
        [1.0, -1.0, -1.0], device=dev)
    return (ndc, torch.as_tensor(np.asarray(faces), dtype=torch.int64,
                                 device=dev),
            torch.as_tensor(np.asarray(colors), dtype=torch.float32,
                            device=dev))


def phase_photo_path(dev, card):
    """Phase 11: the CLI on the card on the RGB scene photo with the seeded
    YOLOv3-tiny, the full U^2-Net and PARE installed under a temporary
    ``ICON_TPU_DATA_DIR``, with ``-hps_type pare -export_video -seg_dir``.
    First the three nets on the card against the CPU on the CLI's own
    inputs (the letterboxed photo, the detector's crop, the PARE input of
    the dataset), each output within NET_RTOL of its largest magnitude and
    the same person box; then the CLI (launches counted); its artifacts,
    the mp4's 360 frames read back with cv2, the garment OBJs against the
    CPU's ``extract_cloth`` on the same mesh and JSON; then the raster
    kernels against the plain version on both turntable meshes at azimuths
    0, 90, 180 and 270 (256^2, K=128, forward only: bin lists,
    pix_to_face, overflow and the composited uint8 frame identical).
    Returns (the launches of the CLI's run, {kernel: worst error})."""
    import json
    import os
    import tempfile

    import cv2
    from icon_tpu_torch.apps.infer import main
    from icon_tpu_torch.ops.cloth_extraction import extract_cloth
    from icon_tpu_torch.ops.raster import rasterize_plain
    from icon_tpu_torch.recon.frame import bench_config
    from icon_tpu_torch.render.render import make_turntable_renderer
    from icon_tpu_torch.utils.io import load_obj
    from icon_tpu_torch.utils.synthetic import write_demo_inputs

    old_root = os.environ.get("ICON_TPU_DATA_DIR")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_demo_inputs(d, bench_config(), detector=True,
                                  segmenter="full", pare_ckpt=True,
                                  seg_dir=True)
        os.remove(os.path.join(paths["in_dir"], "matte.png"))
        os.environ["ICON_TPU_DATA_DIR"] = paths["data_dir"]
        inputs_s = time.perf_counter() - t0
        try:
            photo_nets_agree(dev, paths)
            argv = ["-cfg", paths["cfg"], "-in_dir", paths["in_dir"],
                    "-out_dir", paths["out_dir"], "-ckpt", paths["ckpt"],
                    "-normal_ckpt", paths["normal_ckpt"], "-hps_type",
                    "pare", "-export_video", "-seg_dir", paths["seg_dir"],
                    "-img_size", str(FIT_SIZE), "-mcube_res", str(FIT_RES),
                    "-loop_smpl", "100", "-loop_cloth", "200", "-no_remesh"]
            torch.cuda.synchronize()
            reset_launches()          # count only the main path's launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (record,) = main(argv, device=dev, keep_meshes=True)
            total_s = time.perf_counter() - t0
            launched = read_launches()
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            if old_root is None:
                os.environ.pop("ICON_TPU_DATA_DIR", None)
            else:
                os.environ["ICON_TPU_DATA_DIR"] = old_root
        out = paths["out_dir"]
        written = sorted(os.listdir(out))
        cap = cv2.VideoCapture(os.path.join(out, "scene_cloth.mp4"))
        n_frames, frame_shape = 0, None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n_frames, frame_shape = n_frames + 1, frame.shape
        cap.release()
        with open(os.path.join(paths["seg_dir"], "scene.json")) as f:
            segs = json.load(f)
        garments = {}
        for seg in segs:
            got = load_obj(os.path.join(out, f"scene_{seg['type']}.obj"))
            want = extract_cloth(*record["meshes"]["final"], seg)
            garments[seg["type"]] = ((len(got[0]), len(got[1])),
                                     (len(want[0]), len(want[1])))

    st = record["stages"]
    n_fit, n_cloth = len(record["fit_losses"]), len(record["cloth_losses"])
    print(f"[11] scene (YOLO box, U^2-Net full matte, PARE): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in st.items())
          + f"; fit {st['fit'] / max(n_fit, 1):.4f} s/iteration "
          f"({record['fit_losses'][0]:.5f} -> {record['fit_losses'][-1]:.5f})"
          f", cloth {st.get('cloth', 0.0) / max(n_cloth, 1):.4f} "
          f"s/iteration; recon {record['recon'][0]} verts / "
          f"{record['recon'][1]} tris, levels {record['stats']}", flush=True)
    print(f"[11] demo CLI with the photo path: {total_s:.2f} s, launches "
          f"{launched}, peak {peak_gb:.2f} GiB on {card}, TF32 off; inputs "
          f"written in {inputs_s:.2f} s; mp4 {n_frames} frames of "
          f"{frame_shape}; garments (OBJ, CPU extract_cloth) {garments}",
          flush=True)
    check_launched(launched, ("knn_f32", *RASTER_REPLACES), "phase 11")
    want = sorted(f"scene{s}" for s in CLI_ARTIFACTS +
                  ("_cloth.mp4", "_upper.obj", "_lower.obj"))
    if written != want:
        raise AssertionError(f"phase 11 artifacts {written}, want {want}")
    if n_frames != 360 or frame_shape != (256, 4 * 256, 3):
        raise AssertionError(f"mp4: {n_frames} frames of {frame_shape}")
    if any(g != c for g, c in garments.values()) or \
            set(garments) != set(record["garments"]):
        raise AssertionError(f"garments {garments} vs {record['garments']}")
    if len(record["fit_losses"]) != 100 or \
            len(record["cloth_losses"]) != 200 or not np.isfinite(
                record["fit_losses"] + record["cloth_losses"]).all():
        raise AssertionError("phase 11: loops short or non-finite")
    if record["recon"][1] < 10000 or any(
            v for k, v in record["stats"].items() if k.endswith("overflow")):
        raise AssertionError(f"phase 11: recon {record['recon']}, "
                             f"{record['stats']}")
    if not {"detect", "matte", "hps", "video", "garments"} <= set(st):
        raise AssertionError(f"phase 11 stages {sorted(st)}")

    # the raster kernels on the turntable's inputs
    worst = dict.fromkeys(("raster_setup", "raster_bin", "raster_fwd"), 0.0)
    overflow = {}
    rng = np.random.RandomState(13)
    faces_np = record["meshes"]["final"][1]      # both meshes' faces
    for label, (verts, colors) in zip(("pre-refine", "refined"),
                                      record["meshes"]["turntable"]):
        for az in (0.0, 90.0, 180.0, 270.0):
            ndc, f, c = turntable_inputs(verts, faces_np, colors, az, dev)
            errs, overflow[f"{label} az {az:g}"], _ = compare_raster(
                "[11]", f"turntable {label} az {az:g} 256^2 K=128", ndc, f,
                c, 256, 128, rng, backward=False)
            for k in worst:
                worst[k] = max(worst[k], errs[k])
            v_rot = ndc * torch.tensor([1.0, -1.0, -1.0], device=dev)
            frame = make_turntable_renderer(f, c, 256, 128)(v_rot)
            with torch.no_grad():
                ref = rasterize_plain(ndc, f, c, H=256, W=256, K=128)
            m = ref.mask[..., None]
            plain = ref.attr * m + 0.5 * (1.0 - m)
            u8 = [(x.clamp(0.0, 1.0) * 255).to(torch.uint8)
                  for x in (frame, plain)]
            d_float = float((frame - plain).abs().max())
            n_u8 = int((u8[0] != u8[1]).sum())
            print(f"[11] turntable {label} az {az:g}: composited frame "
                  f"max|d| {d_float:.3g}, uint8 values that differ {n_u8}",
                  flush=True)
            if n_u8 or d_float > RASTER_KERNEL_ATOL["attr"]:
                raise AssertionError("the turntable frame differs from the "
                                     "plain version's")
    whole = {}
    for label, (verts, colors) in zip(("pre-refine", "refined"),
                                      record["meshes"]["turntable"]):
        ndc, f, c = turntable_inputs(verts, faces_np, colors, 0.0, dev)
        v_rot = ndc * torch.tensor([1.0, -1.0, -1.0], device=dev)
        render = make_turntable_renderer(f, c, 256, 128)
        whole[label] = (cuda_ms(lambda: render(v_rot)), len(verts))
    print(f"[11] bin_overflow {overflow}", flush=True)
    print(f"[11] turntable frame (three raster launches and the composite, "
          f"256^2 K=128), ms: " + ", ".join(
              f"{k} {ms:.4f} ({n} verts, {len(faces_np)} faces)"
              for k, (ms, n) in whole.items()) + f" on {card}", flush=True)
    return launched, worst


def photo_nets_agree(dev, paths) -> None:
    """YOLO, U^2-Net and PARE on the card against the CPU on phase 11's
    inputs: the letterboxed photo, the detector's crop and the dataset's
    PARE input; prints each net's error and its forward's CUDA-event time
    on the card."""
    import os
    from PIL import Image
    from icon_tpu_torch.data.test_dataset import PAREWrapper, TestDataset
    from icon_tpu_torch.models import u2net, yolo
    scene = os.path.join(paths["in_dir"], "scene.png")
    rgb = np.asarray(Image.open(scene).convert("RGB"), np.float32) / 255.0
    dets = {n: yolo.PersonDetector(paths["yolo"], device=n)
            for n in ("cpu", dev)}
    inp, _, _, _ = yolo._letterbox(rgb)
    heads = {n: det.heads(inp) for n, det in dets.items()}
    errs = {"yolo heads": max(rel_err(g, c) for g, c in
                              zip(heads[dev], heads["cpu"]))}
    boxes = {n: yolo.person_bbox(det, rgb) for n, det in dets.items()}
    y0, x0, y1, x1 = boxes[dev]
    crop = rgb[y0:y1, x0:x1]
    x = torch.from_numpy(u2net.segmenter_input(crop))[None]
    segs = {n: u2net.build_segmenter(paths["u2net"], lite=False, device=n)
            for n in ("cpu", dev)}
    with torch.no_grad():
        logits = {n: s.net.logits(x.to(n)) for n, s in segs.items()}
    errs["u2net logits"] = max(rel_err(logits[dev][:, i],
                                       logits["cpu"][:, i])
                               for i in range(7))
    alpha = {n: s(crop) for n, s in segs.items()}
    img_hps = TestDataset(paths["in_dir"], hps_type="pare",
                          icon_size=FIT_SIZE, device="cpu").preprocess(
        0)[1][1]
    x_hps = torch.from_numpy(img_hps)[None]
    pares = {n: PAREWrapper(paths["pare_ckpt"], device=n)
             for n in ("cpu", dev)}
    outs = {n: w(x_hps) for n, w in pares.items()}
    for k in ("pred_pose", "pred_shape", "pred_cam", "smpl_vertices",
              "pred_segm_mask"):
        errs[f"pare {k}"] = rel_err(outs[dev][k], outs["cpu"][k])
    x_dev, inp_dev = x.to(dev), torch.from_numpy(inp)[None].to(dev)
    with torch.no_grad():
        ms = {"yolo": cuda_ms(lambda: dets[dev].net(inp_dev)),
              "u2net": cuda_ms(lambda: segs[dev].net(x_dev)),
              "pare": cuda_ms(lambda: pares[dev](x_hps))}
    print(f"[11] nets on the card vs the CPU (max error over each array's "
          f"largest magnitude): " + ", ".join(
              f"{k} {e:.3g}" for k, e in errs.items())
          + f"; person box card {boxes[dev]} cpu {boxes['cpu']}; matte "
          f"max|d| {float(np.abs(alpha[dev] - alpha['cpu']).max()):.3g} "
          f"(mean {float(alpha[dev].mean()):.3f}); forward alone on the "
          f"card (CUDA events), ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
    if boxes[dev] is None or boxes[dev] != boxes["cpu"]:
        raise AssertionError(f"person boxes {boxes}")
    bad = {k: e for k, e in errs.items() if not e <= NET_RTOL}
    if bad:
        raise AssertionError(f"nets on the card disagree with the CPU: "
                             f"{bad}")


def phase_other_hps(dev, card):
    """Phase 12: the demo's other estimators on the card. Seeded published
    files of PIXIE (HRNet-W48 and two ResNet-50s) and HybrIK (ResNet-34 at
    256^2) under a temporary ``ICON_TPU_DATA_DIR``; both nets on the card
    against the CPU on the CLI's own input (:func:`other_nets_agree`); the
    CLI on the RGB scene photo with ``-hps_type pixie`` (the SMPL-X body
    through the fit frame; every kNN call recorded) and then ``-hps_type
    hybrik``, each with 100 fit and 200 cloth iterations, ``-no_remesh``,
    its launches counted; the artifacts, the loops, the recon; then the
    kernels against their plain versions on the PIXIE run's own inputs
    (:func:`cli_kernels_agree`: the kNN calls against the SMPL-X body, the
    raster kernels on its fitted body, recon and refined mesh). Returns
    ([the launches of each run], {kernel: worst error})."""
    import os
    import tempfile
    from icon_tpu_torch.apps.infer import main
    from icon_tpu_torch.recon.frame import bench_config
    from icon_tpu_torch.utils.synthetic import write_demo_inputs

    old_root = os.environ.get("ICON_TPU_DATA_DIR")
    records, runs, knn_calls = {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_demo_inputs(d, bench_config(), pixie_ckpt=True,
                                  hybrik_ckpt=True)
        os.remove(os.path.join(paths["in_dir"], "matte.png"))
        os.environ["ICON_TPU_DATA_DIR"] = paths["data_dir"]
        inputs_s = time.perf_counter() - t0
        try:
            other_nets_agree(dev, card, paths)
            for hps_type in ("pixie", "hybrik"):
                out = os.path.join(d, f"out_{hps_type}")
                argv = ["-cfg", paths["cfg"], "-in_dir", paths["in_dir"],
                        "-out_dir", out, "-ckpt", paths["ckpt"],
                        "-normal_ckpt", paths["normal_ckpt"], "-hps_type",
                        hps_type, "-img_size", str(FIT_SIZE), "-mcube_res",
                        str(FIT_RES), "-loop_smpl", "100", "-loop_cloth",
                        "200", "-no_remesh"]
                torch.cuda.synchronize()
                remove_spy = knn_spy(knn_calls if hps_type == "pixie"
                                     else [])
                reset_launches()      # count only the main path's launches
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    (record,) = main(argv, device=dev, keep_meshes=True)
                finally:
                    remove_spy()
                record["total_s"] = time.perf_counter() - t0
                record["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
                record["written"] = sorted(os.listdir(out))
                record["fit"] = np.load(os.path.join(out, "scene_smpl.npy"),
                                        allow_pickle=True).item()
                records[hps_type], runs[hps_type] = record, read_launches()
        finally:
            if old_root is None:
                os.environ.pop("ICON_TPU_DATA_DIR", None)
            else:
                os.environ["ICON_TPU_DATA_DIR"] = old_root

    want = sorted(f"scene{s}" for s in CLI_ARTIFACTS)
    for hps_type, r in records.items():
        st = r["stages"]
        n_fit, n_cloth = len(r["fit_losses"]), len(r["cloth_losses"])
        print(f"[12] scene, -hps_type {hps_type}: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in st.items())
            + f"; fit {st['fit'] / max(n_fit, 1):.4f} s/iteration "
            f"({r['fit_losses'][0]:.5f} -> {r['fit_losses'][-1]:.5f}), "
            f"cloth {st.get('cloth', 0.0) / max(n_cloth, 1):.4f} s/iteration"
            f"; body {r['meshes']['body'][0].shape[0]} verts / "
            f"{len(r['meshes']['body'][1])} faces, pose "
            f"{r['fit']['pose'].shape}, betas {r['fit']['betas'].shape}; "
            f"recon {r['recon'][0]} verts / {r['recon'][1]} tris, levels "
            f"{r['stats']}; main {r['total_s']:.2f} s, launches "
            f"{runs[hps_type]}, peak {r['peak_gb']:.2f} GiB on {card}, TF32 "
            f"off; inputs written in {inputs_s:.2f} s", flush=True)
        check_launched(runs[hps_type], ("knn_f32", *RASTER_REPLACES),
                       f"phase 12 ({hps_type})")
        if r["written"] != want:
            raise AssertionError(f"phase 12 {hps_type} artifacts "
                                 f"{r['written']}, want {want}")
        if n_fit != 100 or n_cloth != 200 or not np.isfinite(
                r["fit_losses"] + r["cloth_losses"]).all():
            raise AssertionError(f"phase 12 {hps_type}: loops short or "
                                 "non-finite")
        if r["recon"][1] < 10000 or any(
                v for k, v in r["stats"].items() if k.endswith("overflow")):
            raise AssertionError(f"phase 12 {hps_type}: recon {r['recon']}"
                                 f", {r['stats']}")
        n_joints = 21 if hps_type == "pixie" else 23
        if r["fit"]["pose"].shape != (1, n_joints, 3, 3) or \
                r["fit"]["betas"].shape != (1, 10):
            raise AssertionError(f"phase 12 {hps_type}: fit pose "
                                 f"{r['fit']['pose'].shape}")
    worst = cli_kernels_agree("[12]", [records["pixie"]], knn_calls,
                              runs["pixie"], dev, seed=14)
    return [runs["pixie"], runs["hybrik"]], worst


def other_nets_agree(dev, card, paths) -> None:
    """PIXIE and HybrIK on the card against the CPU on phase 12's input
    (the dataset's HPS crop of the scene photo), each output within NET_RTOL
    of its largest magnitude: PIXIE's SMPL-X vertices, joints, rotations,
    shape, expression and camera; HybrIK's uvd, xyz, twists, shape and
    camera. HybrIK's IK and body: the synthetic SMPL's tree is a chain, so
    the root's Procrustes leaves the twist about its one bone to the SVD,
    which cuSOLVER and LAPACK may choose apart; the card's rotations must be
    proper and put every rest bone on the bone they solve for
    (``bone_alignment``), and the IK alone on a seeded skeleton of SMPL's
    tree (each Procrustes well posed) must equal the CPU's. Prints each
    wrapper's build and load time, each forward alone on the card (CUDA
    events) and the IK's share."""
    from icon_tpu_torch.data.test_dataset import (HybrIKWrapper,
                                                  PIXIEWrapper, TestDataset)
    from icon_tpu_torch.models.hybrik import ik
    from icon_tpu_torch.models.smplx.lbs import batch_rodrigues

    img_hps = TestDataset(paths["in_dir"], icon_size=FIT_SIZE,
                          device="cpu").preprocess(0)[1][1]
    x = torch.from_numpy(img_hps)[None]
    errs, ms, build_s, outs = {}, {}, {}, {}
    for name, cls, ckpt, keys in (
            ("pixie", PIXIEWrapper, paths["pixie_ckpt"],
             ("vertices", "joints", "global_pose", "body_pose", "jaw_pose",
              "left_hand_pose", "right_hand_pose", "shape", "exp", "cam")),
            ("hybrik", HybrIKWrapper, paths["hybrik_ckpt"],
             ("pred_uvd_jts", "pred_xyz_jts", "pred_phi", "pred_shape",
              "pred_camera"))):
        outs[name, "cpu"] = cls(ckpt, device="cpu")(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_hps = cls(ckpt, device=dev)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        outs[name, str(dev)] = card_hps(x)
        for k in keys:
            errs[f"{name} {k}"] = rel_err(outs[name, str(dev)][k],
                                          outs[name, "cpu"][k])
        ms[name] = cuda_ms(lambda: card_hps(x))
    # HybrIK's IK on the card (card_hps is HybrIK's wrapper)
    got = outs["hybrik", str(dev)]
    net = card_hps.net
    J = len(net.parents)
    skel = got["pred_xyz_jts"][:, :J] * 2.2
    rest = net.rest_joints[None].expand(1, J, 3)
    rot = got["pred_theta_mats"]
    det = torch.linalg.det(rot)
    align = float(ik.bone_alignment(rot, skel, rest, net.parents).min())
    chain_diff = rel_err(rot, outs["hybrik", "cpu"]["pred_theta_mats"])
    with torch.no_grad():
        ms["hybrik IK"] = cuda_ms(lambda: ik.hybrik_ik(
            skel, got["pred_phi"], rest, net.parents))
    smpl_tree = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                 16, 17, 18, 19, 20, 21)
    rng = np.random.RandomState(15)
    R = batch_rodrigues(torch.from_numpy(
        (0.5 * rng.randn(J, 3)).astype(np.float32))).to(dev)
    glob, pos = [R[0]], [rest[0, 0]]
    for i in range(1, J):
        p = smpl_tree[i]
        glob.append(glob[p] @ R[i])
        pos.append(pos[p] + glob[p] @ (rest[0, i] - rest[0, p]))
    tree_skel = torch.stack(pos)[None] - pos[0]
    phi = torch.from_numpy(rng.randn(1, J - 1, 2).astype(np.float32)).to(dev)
    tree = {n: ik.hybrik_ik(tree_skel.to(n), phi.to(n), rest.to(n),
                            smpl_tree) for n in ("cpu", dev)}
    errs["hybrik IK on SMPL's tree"] = rel_err(tree[dev], tree["cpu"])
    print(f"[12] nets on the card vs the CPU (max error over each array's "
          f"largest magnitude): " + ", ".join(
              f"{k} {e:.3g}" for k, e in errs.items())
          + f"; HybrIK on the chain body: rotations det in "
          f"[{float(det.min()):.6f}, {float(det.max()):.6f}], least bone "
          f"cosine {align:.7f}, rotations vs the CPU's {chain_diff:.3g} (the "
          f"root's twist is the SVD's choice); build and load, s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in build_s.items())
          + "; forward alone on the card (CUDA events, the IK's SVDs on "
          f"cuSOLVER included), ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in ms.items()) + f" on {card}",
          flush=True)
    bad = {k: e for k, e in errs.items() if not e <= NET_RTOL}
    if bad:
        raise AssertionError(f"nets on the card disagree with the CPU: "
                             f"{bad}")
    # a bone nearly parallel to its rest bone leaves the swing's axis short
    # of unit length by the algorithm's 1e-8 guard (both packages): det
    # within IK_DET_TOL
    if not (align > 1 - 1e-4 and float((det - 1).abs().max()) < IK_DET_TOL):
        raise AssertionError("HybrIK's IK on the card is not a proper "
                             "rotation onto the solved bones")

def voxel_spy(calls: list):
    """A pass-through spy on the voxelize wrapper's two kernels that records
    each call's inputs (cloned) in ``calls`` as (kernel, arguments) and
    counts nothing; returns a function that removes it."""
    from icon_tpu_torch.kernels import voxelize as kv
    splat, smooth = kv.voxel_splat, kv.box_smooth3d

    def spy_splat(verts, codes, res):
        calls.append(("voxel_splat", (verts.detach().clone(),
                                      codes.detach().clone(), res)))
        return splat(verts, codes, res)

    def spy_smooth(acc, k):
        calls.append(("box_smooth3d", (acc.detach().clone(), k)))
        return smooth(acc, k)

    kv.voxel_splat, kv.box_smooth3d = spy_splat, spy_smooth

    def remove():
        kv.voxel_splat, kv.box_smooth3d = splat, smooth
    return remove


def voxel_agrees(name, args):
    """(max |kernel - plain|, whether the kernel passes, a note) of one
    voxelize kernel against its plain version on ``args``: ``box_smooth3d``
    bit-identical; ``voxel_splat`` within 2 m 2^-24 of each voxel's plain
    sum of m terms (``ops/voxelize.py:splat_terms``)."""
    from icon_tpu_torch.kernels import voxelize as kv
    from icon_tpu_torch.ops import voxelize as pv
    if name == "box_smooth3d":
        got, want = kv.box_smooth3d(*args), pv.box_smooth3d_plain(*args)
        torch.cuda.synchronize()
        return float((got - want).abs().max()), torch.equal(got, want), \
            "identical" if torch.equal(got, want) else "differs"
    verts, codes, res = args
    got, want = kv.voxel_splat(*args), pv.voxel_splat_plain(*args)
    torch.cuda.synchronize()
    terms = pv.splat_terms(verts, res)[..., None].float()
    diff = (got - want).abs()
    ok = bool((diff <= 2.0 * terms * ORDER_EPS * want.abs()).all())
    ulps = float((diff / (want.abs() * ORDER_EPS).clamp(min=1e-30)).max())
    return float(diff.max()), ok, (f"within the order bound: {ok}, at most "
                                   f"{int(terms.max())} terms a voxel, "
                                   f"{ulps:.3g} x 2^-24 of a sum")


def phase_small_prior_frames(dev):
    """[13] The pifu and pamir fit frames at image 64^2, res 128, the
    subdiv-3 SMPL-X-layout body, ``-loop_smpl 0`` (the body's normals
    through the NormalNet), bench.py's widths for the prior and its variant
    field, one cloth iteration, on the card vs on the CPU: level and
    marched triangle counts equal; from the CPU's body, the raw net
    occupancy at the level-0 points to 1e-4 (PaMIR's voxel volume through
    the kernels on the card, the plain version on the CPU). Returns the
    card's pamir voxel inputs (``pamir_feats`` of its fit)."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.engine import reconstruction_resolutions
    from icon_tpu_torch.recon.frame import (bench_config, build_fit_frame,
                                            pamir_feats, seeded_state,
                                            variant_occ)
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    res0 = reconstruction_resolutions(128)[0]
    vox = None
    for prior in ("pifu", "pamir"):
        cfg = bench_config(prior)
        state = seeded_state(cfg, 1, normal_net=True)
        item = synthetic_fit_item(synthetic_smplx_model(subdiv=3), 64,
                                  seed=1)
        frames, out, raw = {}, {}, {}
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            frames[name] = build_fit_frame(
                cfg, state, synthetic_smplx_model(subdiv=3), 128, device,
                loop_smpl=0, loop_cloth=1, field=variant_occ)
            out[name] = frames[name].frame(item)
        c, g = out["cpu"], out["gpu"]
        counts = [(int(r.stats["level1_points"]), len(r.recon[1]))
                  for r in (c, g)]
        scale = float(item["scale"])
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            calib = torch.from_numpy(item["calib"]).to(device)
            smpl, feats = frames[name].prep(
                torch.from_numpy(item["image"]).to(device),
                fit_on(c.fit, device), calib, scale)
            with torch.no_grad():
                raw[name] = frames[name].net_occ(
                    level0_points(res0, device), smpl, feats,
                    calib).cpu().numpy()
        occ_err = float(np.abs(raw["cpu"] - raw["gpu"]).max())
        print(f"[13] small {prior} frame, card vs CPU: level1, marched "
              f"triangles {counts[1]} vs {counts[0]}; from the CPU's body: "
              f"raw occupancy max|d| {occ_err:.3g} (std "
              f"{raw['cpu'].std():.3g}); cloth losses {g.cloth_losses} vs "
              f"{c.cloth_losses}", flush=True)
        if counts[0] != counts[1] or not occ_err <= 1e-4 or \
                not raw["cpu"].std() > 0 or \
                not np.isfinite(g.cloth_losses).all():
            raise AssertionError(f"small {prior} frame on the card "
                                 "disagrees with the CPU")
        if prior == "pamir":
            vox = pamir_feats(g.fit.verts, frames["gpu"].body, g.fit.params,
                              scale, torch.from_numpy(item["calib"]).to(dev))
    return vox


def voxel_stress(vox):
    """The splat's stress input: the pamir frame's voxel inputs with their
    last :data:`VOXEL_STRESS_PADS` vertices at the frame's padding point
    (its last vertex, ``pamir_feats``'s zero padding projected) and zero
    codes."""
    verts, codes = vox["voxel_verts"].clone(), vox["voxel_codes"].clone()
    verts[:, -VOXEL_STRESS_PADS:] = verts[:, -1:]
    codes[-VOXEL_STRESS_PADS:] = 0.0
    return verts, codes


def voxel_kernel_entries(dev, vox):
    """[13] The voxelize kernels against their plain versions on the pamir
    frame's own voxel inputs at 128^3 (the box smooth on the plain splat's
    accumulator) and the splat also on :func:`voxel_stress`; the smooth's
    division by k against IEEE division; each kernel alone (its launches
    on preallocated buffers behind a device sleep), the plain version, one
    library call (the splat: ``index_add_`` of the 8 corners' precomputed
    rows into a zeroed buffer; the smooth: ``avg_pool3d`` with
    ``count_include_pad``, which leaves out the division by the weights),
    the bound and the previous design's time. Returns the summary entries (the frame's
    inputs)."""
    import torch.nn.functional as F
    from icon_tpu_torch.kernels import voxelize as kv
    from icon_tpu_torch.ops import voxelize as pv
    res = VOXEL_RES
    k = pv.smooth_kernel_size(res, 0.05)
    n = res ** 3
    inputs = {"frame": (vox["voxel_verts"], vox["voxel_codes"]),
              "stress": voxel_stress(vox)}
    acc = pv.voxel_splat_plain(*inputs["frame"], res).view(
        1, res, res, res, 4)
    errs = {}
    for name, label, args in (
            ("voxel_splat", "frame", (*inputs["frame"], res)),
            ("voxel_splat", "stress", (*inputs["stress"], res)),
            ("box_smooth3d", "frame", (acc, k))):
        err, ok, note = voxel_agrees(name, args)
        pads = int((inputs[label][0][0] == inputs[label][0][0, -1]).all(
            -1).sum())
        print(f"[13] {name} vs plain on the pamir {label}'s 8,000 voxel "
              f"vertices ({pads} at the padding point) at {res}^3 "
              f"(k={k}): max|d| {err:.3g}, {note}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the {label} input")
        errs[name] = max(errs.get(name, 0.0), err)
    bad = kv.division_mismatches()
    print(f"[13] box_smooth3d's division by k vs IEEE division: {bad} "
          f"mismatches over every float32 in [1, 2) and k <= {kv.MAX_K}",
          flush=True)
    if bad:
        raise AssertionError("box_smooth3d's division by k is not "
                             "correctly rounded")

    def splat_times(verts, codes):
        buf = torch.empty((1, n, 4), device=dev)
        corners = list(pv._corners(verts, res))
        lin = torch.cat([c[0].reshape(-1) for c in corners])
        rows = torch.cat([torch.cat([w[..., None] * codes[None],
                                     w[..., None]], -1).reshape(-1, 4)
                          for _, w in corners])
        lib_buf = torch.empty((n, 4), device=dev)
        return (kernel_ms(lambda: kv._splat(verts, codes, res, buf)),
                cuda_ms(lambda: pv.voxel_splat_plain(verts, codes, res)),
                cuda_ms(lambda: lib_buf.zero_().index_add_(0, lin, rows)),
                bound(4.0 * (verts.numel() + codes.numel() + 4 * n),
                      SPLAT_OPS_PER_VERTEX * verts.shape[1]))

    t1 = torch.empty_like(acc)
    vol = torch.empty(acc.shape[:4] + (3,), device=dev)
    pool_in = acc.permute(0, 4, 1, 2, 3)
    times = {
        ("voxel_splat", "frame"): splat_times(*inputs["frame"]),
        ("voxel_splat", "stress"): splat_times(*inputs["stress"]),
        ("box_smooth3d", "frame"): (
            kernel_ms(lambda: kv._smooth(acc, k, t1, vol)),
            cuda_ms(lambda: pv.box_smooth3d_plain(acc, k)),
            cuda_ms(lambda: F.avg_pool3d(pool_in, k, stride=1,
                                         padding=k // 2,
                                         count_include_pad=True)),
            bound(4.0 * (4 + 3) * n, (3 * 4 * (k + 1) + 3) * n))}
    entries = []
    for (name, label), (ms, plain_ms, lib_ms, (bound_ms, by)) in \
            times.items():
        before = " / ".join(f"{t:.4f}" for t in VOXEL_BEFORE_MS[name])
        print(f"[13] {name} on the {label} input alone {ms:.4f} ms (bound "
              f"{bound_ms:.4f} ms by {by}, {bound_ms / ms:.1%}), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"({lib_ms / ms:.2f}x the kernel), the previous design "
              f"{before} ms",
              flush=True)
        if label == "frame":
            entries.append({
                "name": name, "route": "cuda",
                "source": "icon_tpu_torch/csrc/voxelize.cu",
                "replaces": VOXEL_REPLACES[name], "launches": 0,
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms})
    return entries


def phase_pamir_frame(dev, card, iters: int = 5):
    """[13] The pamir serving frame at full width (bench.py's widths for
    pamir, the subdiv-5 SMPL-X-layout body, 512^2, res 256, the variant
    field): the body as estimated (``-loop_smpl 0``), then 3 warm-up and
    ``iters`` timed recons, each stage ended by a synchronize: filter, prep
    (voxelize: ``pamir_feats`` and the two kernels; ve: the volume
    encoder), engine, march (with the pack), decode; peak memory; level
    counts against the JAX package's. Returns the launches."""
    from icon_tpu_torch.kernels.voxelize import voxelize_semantic
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import (bench_config, build_fit_frame,
                                            pamir_feats, seeded_state,
                                            variant_occ)
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    cfg = bench_config("pamir")
    t0 = time.perf_counter()
    fr = build_fit_frame(cfg, seeded_state(cfg, 0, normal_net=True),
                         synthetic_smplx_model(subdiv=FIT_SUBDIV), FIT_RES,
                         dev, loop_smpl=0, field=variant_occ)
    item = synthetic_fit_item(fr.body, FIT_SIZE, seed=0)
    image = torch.from_numpy(item["image"]).to(dev)
    calib = torch.from_numpy(item["calib"]).to(dev)
    scale = float(item["scale"])
    fit = fr.fit(item)
    nml_f, nml_b = fit.normals
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    @torch.no_grad()
    def recon():
        stage = {}

        def timed(name, fn, *args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stage[name] = time.perf_counter() - t
            return out

        feats = timed("filter", fr.net.filter, {
            "image": image[None], "normal_F": nml_f[None],
            "normal_B": nml_b[None]})

        def voxelize():
            vox = pamir_feats(fit.verts, fr.body, fit.params, scale, calib)
            return voxelize_semantic(vox["voxel_verts"], vox["voxel_codes"],
                                     res=cfg.net.voxel_res)
        vol = timed("voxelize", voxelize)
        vol_feats = timed("ve", lambda: [f.permute(0, 2, 3, 4, 1) for f in
                                         fr.net.ve(vol.permute(0, 4, 1, 2,
                                                               3))])
        stage["prep"] = stage["voxelize"] + stage["ve"]
        occ, stats = timed("engine", fr.engine, fr.query_fn, query_args=(
            {"voxel_feats": vol_feats}, feats, calib))
        token = timed("march", lambda: fr.marcher.pack(fr.marcher(
            occ, coarse_occ=stats["coarse_occ"])))
        verts, faces = timed("decode", fr.marcher.unpack, token)
        return stage, stats, verts, faces

    reset_launches()                  # count only the main path's launches
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        recon()
    runs = [recon() for _ in range(iters)]
    launched = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _, stats, verts, faces = runs[-1]
    med = {k: statistics.median(r[0][k] for r in runs) for k in runs[0][0]}
    total = [sum(v for k, v in r[0].items() if k not in ("voxelize", "ve"))
             for r in runs]
    l1, l2 = int(stats["level1_points"]), int(stats["level2_points"])
    ov = [int(stats[k]) for k in sorted(stats) if k.endswith("_overflow")]
    print(f"[13] pamir frame (median of {iters}, s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in med.items()) + f"; recon median "
        f"{statistics.median(total):.4f} all {[round(x, 4) for x in total]}; "
        f"level1 {l1} (JAX {JAX_PAMIR_LEVEL1_POINTS}), level2 {l2} (JAX "
        f"{JAX_PAMIR_LEVEL2_POINTS}), {len(verts)} verts / {len(faces)} tris, "
        f"overflow {ov}; launches {launched}; peak {peak_gb:.2f} GiB; setup "
        f"{setup_s:.2f} s on {card}, TF32 off", flush=True)
    check_launched(launched, tuple(VOXEL_REPLACES), "the pamir frame")
    if len(faces) < 10000 or not np.isfinite(verts).all() or any(ov):
        raise AssertionError("the pamir frame's mesh is empty, non-finite "
                             "or overflowed")
    for name, got, ref in (("level1_points", l1, JAX_PAMIR_LEVEL1_POINTS),
                           ("level2_points", l2, JAX_PAMIR_LEVEL2_POINTS)):
        if abs(got - ref) > COUNT_RTOL * ref:
            raise AssertionError(f"{name} {got} vs JAX {ref}")
    return launched


def phase_prior_cli(dev, card):
    """[13] The CLI on the card on the RGB scene photo with a pifu config
    (bench.py's widths without the filter) and a pamir config (bench.py's
    widths), seeded reference-layout checkpoints (``prior_readout``;
    pamir's with the volume encoder's dead modules) and the seeded PyMAF,
    ``-loop_smpl 100 -loop_cloth 20 -no_remesh`` at 512^2 and res 256,
    launches counted; the artifacts (no ``_smpl.*`` for pifu), the loops,
    the recon, the stage split; then every voxelize launch of the pamir
    run (recorded by :func:`voxel_spy`) against the plain version on that
    launch's inputs. Returns ([the launches of each run], {kernel: worst
    error})."""
    import dataclasses
    import os
    import tempfile
    from icon_tpu_torch.apps.infer import main
    from icon_tpu_torch.recon.frame import bench_config
    from icon_tpu_torch.utils.synthetic import write_demo_inputs

    records, runs, calls = {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        for prior in ("pifu", "pamir"):
            cfg = bench_config(prior)
            if prior == "pifu":
                cfg = cfg.replace(net=dataclasses.replace(cfg.net,
                                                          use_filter=False))
            paths = write_demo_inputs(os.path.join(d, prior), cfg,
                                      hps_ckpt=True)
            os.remove(os.path.join(paths["in_dir"], "matte.png"))
            argv = ["-cfg", paths["cfg"], "-in_dir", paths["in_dir"],
                    "-out_dir", paths["out_dir"], "-ckpt", paths["ckpt"],
                    "-normal_ckpt", paths["normal_ckpt"], "-hps_ckpt",
                    paths["hps_ckpt"], "-hps_type", "pymaf", "-loop_smpl",
                    "100", "-loop_cloth", "20", "-no_remesh", "-img_size",
                    str(FIT_SIZE), "-mcube_res", str(FIT_RES)]
            torch.cuda.synchronize()
            remove_spy = voxel_spy(calls if prior == "pamir" else [])
            reset_launches()          # count only the main path's launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                (record,) = main(argv, device=dev)
            finally:
                remove_spy()
            record["total_s"] = time.perf_counter() - t0
            record["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            record["written"] = sorted(os.listdir(paths["out_dir"]))
            records[prior], runs[prior] = record, read_launches()

    for prior, r in records.items():
        st = r["stages"]
        n_fit, n_cloth = len(r["fit_losses"]), len(r["cloth_losses"])
        print(f"[13] scene, {prior} prior: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in st.items())
            + (f"; fit {st['fit'] / n_fit:.4f} s/iteration "
               f"({r['fit_losses'][0]:.5f} -> {r['fit_losses'][-1]:.5f})"
               if n_fit else "; no fit")
            + f", cloth {st.get('cloth', 0.0) / max(n_cloth, 1):.4f} "
            f"s/iteration; recon {r['recon'][0]} verts / {r['recon'][1]} "
            f"tris, levels {r['stats']}; main {r['total_s']:.2f} s, launches "
            f"{runs[prior]}, peak {r['peak_gb']:.2f} GiB on {card}, TF32 off",
            flush=True)
        kernels = RASTER_REPLACES if prior == "pifu" else \
            (*RASTER_REPLACES, *VOXEL_REPLACES)
        check_launched(runs[prior], kernels, f"the {prior} CLI")
        want = sorted(f"scene{s}" for s in CLI_ARTIFACTS
                      if prior == "pamir" or not s.startswith("_smpl"))
        if r["written"] != want:
            raise AssertionError(f"{prior} CLI artifacts {r['written']}, "
                                 f"want {want}")
        if n_fit != (100 if prior == "pamir" else 0) or n_cloth != 20 or \
                not np.isfinite(r["fit_losses"] + r["cloth_losses"]).all():
            raise AssertionError(f"{prior} CLI: loops short or non-finite")
        if r["recon"][1] < 10000 or any(
                v for k, v in r["stats"].items() if k.endswith("overflow")):
            raise AssertionError(f"{prior} CLI: recon {r['recon']}, "
                                 f"{r['stats']}")
        if "cloth" not in st or "recon" not in st:
            raise AssertionError(f"{prior} CLI stages {sorted(st)}")

    worst = dict.fromkeys(VOXEL_REPLACES, 0.0)
    for name in VOXEL_REPLACES:
        n = sum(1 for c, _ in calls if c == name)
        if n != runs["pamir"][name]:
            raise AssertionError(f"{n} {name} calls recorded, "
                                 f"{runs['pamir'][name]} launched")
    for i, (name, args) in enumerate(calls):
        err, ok, note = voxel_agrees(name, args)
        print(f"[13] pamir CLI {name} call {i}: max|d| {err:.3g}, {note}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the CLI's call {i}")
        worst[name] = max(worst[name], err)
    return [runs["pifu"], runs["pamir"]], worst


def phase_priors(dev, card):
    """Phase 13: the pifu and pamir priors. Returns (the voxelize kernels'
    summary entries, the launches of its main-path runs, {kernel: worst
    error})."""
    vox = phase_small_prior_frames(dev)
    entries = voxel_kernel_entries(dev, vox)
    runs = [phase_pamir_frame(dev, card)]
    cli_runs, errs = phase_prior_cli(dev, card)
    return entries, runs + cli_runs, errs


def normal_inputs(verts, faces, azimuth):
    """``normal_raster``'s raster inputs: (ndc, faces, the vertex normals
    in the view frame)."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    from icon_tpu_torch.render.camera import verts_to_ndc, view_matrix
    R = torch.as_tensor(view_matrix(azimuth), dtype=verts.dtype,
                        device=verts.device)
    return (verts_to_ndc(verts, azimuth), faces,
            vertex_normals(verts[None], faces)[0] @ R.T)


def reset_launches() -> None:
    from icon_tpu_torch.kernels import knn, raster, voxelize
    knn.launches = 0
    raster.launches_setup = raster.launches_bin = 0
    raster.launches_fwd = raster.launches_bwd = 0
    voxelize.launches_splat = voxelize.launches_smooth = 0


def read_launches() -> dict:
    from icon_tpu_torch.kernels import knn, raster, voxelize
    return {"knn_f32": knn.launches, "raster_setup": raster.launches_setup,
            "raster_bin": raster.launches_bin,
            "raster_fwd": raster.launches_fwd,
            "raster_bwd": raster.launches_bwd,
            "voxel_splat": voxelize.launches_splat,
            "box_smooth3d": voxelize.launches_smooth}


def check_launched(counts: dict, names, path: str) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{path} never launched {name}")


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
    knn_hmma(so["knn.cu"])

    verts_np, faces_np = synthetic_body(subdiv=5)
    phase_small_frame(dev)
    launched, buckets = phase_full_frame(dev, card)
    runs = [launched]
    summary = [phase_knn(dev, verts_np, buckets)]
    phase_raster(dev, verts_np, faces_np)
    phase_small_normalnet_frame(dev)
    runs.append(phase_full_normalnet_frame(dev, card))
    summary += phase_raster_kernels(dev, verts_np, faces_np)
    phase_small_fit_frame(dev)
    launched, fit_errs = phase_full_fit_frame(dev, card)
    runs.append(launched)
    launched, cli_errs = phase_cli(dev, card)
    runs.append(launched)
    launched, photo_errs = phase_photo_path(dev, card)
    runs.append(launched)
    launched, hps_errs = phase_other_hps(dev, card)
    runs += launched
    entries, launched, prior_errs = phase_priors(dev, card)
    summary += entries
    runs += launched
    for entry in summary:           # the launches of the main paths' runs
        entry["launches"] = sum(run[entry["name"]] for run in runs)
        entry["max_abs_err"] = max(
            entry["max_abs_err"], *(errs.get(entry["name"], 0.0) for errs in
                                    (fit_errs, cli_errs, photo_errs,
                                     hps_errs, prior_errs)))

    print(json.dumps({"kernels": summary}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
