#!/usr/bin/env python3
"""Drive the PyTorch port (icon_tpu_torch) of the ICON serving frame on one
NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (lines tagged [1]..[17], then the /proc check [18], a kernel
summary, the card, and a last JSON line ``{"ok": true, "device":
{...}}``):

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

14. the geometry trainer: the fixture (2 subjects x 3 views at 512^2) on
   the card, its items' signs against the card's ray parity, 3 small
   steps card vs CPU, the train CLI at the published width (4 steps,
   ``-resume`` to 6, ``-test`` on 2 items, a pamir run of 2 steps), the
   kernels against their plain versions on those runs' inputs;
15. the dataset renderer and the NormalNet trainer on phase 14's scans and
   fits, TF32 off: the render CLI at the reference's settings (``-views
   36 -size 512 -prt -prt_dirs 64 -vis_res 4096``, ``-procs 1``; the file
   set, every subject rendered with its body), the raster kernels against
   the plain version on the first and last call of each raster kind of
   that run (512^2 K=256 renders, the 4096^2 K=512 visibility with its
   vertex sets against the run's ``vis/*.npy``, the PRT's 512^2 K=512
   depth rasters), each kernel alone at 4096^2 K=512 and at 512^2 K=512
   beside its bound, ``compute_prt`` card vs CPU, the CLI again with
   ``-procs 2`` (a spawn pool) into a second root, every file byte-equal
   to the ``-procs 1`` run's (else the kinds that differ and their largest
   decoded difference, and a failure), one subject's render
   split under the profiler; then three narrow NormalNet steps card vs CPU
   on rendered items, a full-width step under TF32 off / off with
   ``cudnn.benchmark`` / on, the train_normal CLI at the published width
   (ngf 64, 4 downsamplings, 9 resblocks, batch 4 at 512^2, lr_N 2e-4, a
   seeded VGG19 file in torchvision's layout) for 6 steps and ``-resume``
   to 8; ``poisson_reconstruct`` card vs CPU at res 64 and on the card at
   128; ``apps.tetrahedronize`` on a SMPL pickle of the synthetic body,
   read back by the tetra loader;
16. data-parallel training and point-sharded recon, TF32 off: two ranks
   spawned on the one card over gloo (NCCL refuses two ranks on one card),
   each on its half of the same 4-item global batches of phase 14's
   fixture at the reference's recipe, from the same seeded weights,
   against one process on the whole batch (and on a rank's half): icon
   for 3 steps (the first loss, the BatchNorm statistics after it, the
   parameters after the last), pamir for 1 with its voxelize kernels;
   the kNN kernel against its plain version on each rank's first and last
   call; the gradient all-reduce's ms and bytes, each rank's peak memory;
   a one-rank NCCL group's step against the plain step and an NCCL
   all-reduce; phase 4's full-width frame with ``shard_query`` over two
   shards of the card (``pad_multiple`` 2) against unsharded (level
   counts, triangles, occupancy, latency; the kNN on a shard's first and
   last call); exact mode at 257^3 (``clothed_human_occ``: no overflow and
   no residual at any level; the frame's query beside faster mode); the
   train and demo CLIs with 2 devices, which raise the JAX package's
   too-few-devices error on one card (on two or more cards they run, and
   the ranks run again over NCCL, one a card). Every rank is spawned and
   joined in a ``finally``;
17. signs and meshing: (a) the fast-winding kernel against its plain version
   on the level-0 lattice and the 232,974-point cap around the subdiv-5 body
   and on 4,096 near-surface samples of a posed body (winding numbers to
   1e-5, signs identical where |w - 0.5| > 1e-4, the posed samples' signs
   equal to the dense exact winding's), alone and through its wrapper beside
   its bound, with the registers and occupancy of the instance it launches;
   (b) the pseudo-normal sign card vs CPU at small size, then phase 4's
   full-width frame with the winding-cluster sign through
   ``HGPIFuNet.query`` (level counts and triangles against the JAX
   package's, latency and the engine stage beside the crossing-column
   frame's); (c) that frame's 257^3 grid through ``extract_mesh`` without a
   marcher (``mt_emit``, ``mt_index``): 295,244 triangles, the lattice
   marcher's vertex count and face set, vertices within the u8 step of its,
   the kernels' faces identical to the plain version's and vertices within
   1e-6 grid units, both pack wires, each kernel alone beside its bound; (d)
   ``ReconEngine(virtual_final=True)`` with ``AutoMarcher(virtual=True)``
   against the materialized final level at 257^3 (face set, u8 step), and at
   513^3 both ways' peak memory, the virtual one allocating no fine grid.

Each main path (phases 4, 6, 9, 10, 11, both runs of 12, in 13 the
pamir frame and both CLI runs, 14's fixture, train and eval runs, 15's
render run, in 16 each rank's steps and the sharded recon, and in 17 the
winding-sign frame and the one-shot export) runs with the kernels' launch counts set to
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
``avg_pool3d``, ``mt_index``'s ``torch.unique`` with the inverse; none for
the rasterizer, ``fast_winding`` and ``mt_emit``), and its share of the
bound.
"""

import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
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


def run_cmd(args, timeout: float) -> str:
    """A command's standard output. It runs in a session of its own and is
    waited for in a ``finally``; if it outlives ``timeout`` (or anything
    else fails), its whole process group is killed first."""
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(proc.returncode, args, out, err)
    return out


def card_line() -> str:
    return run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"],
                   timeout=60).strip().splitlines()[0]


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
    sass = run_cmd([cuobjdump, "-sass", lib], timeout=300)
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
    faults = [f"pix_to_face at {differ} px"] if differ else []
    faults += [f"{k} {errs[k]:.3g} > {tol}" for k, tol in
               RASTER_KERNEL_ATOL.items() if errs[k] > tol]
    if grad_rel > RASTER_GRAD_RTOL:
        faults.append(f"grads {grad_rel:.3g} of the largest > "
                      f"{RASTER_GRAD_RTOL}")
    if int(out.bin_overflow) != int(ref.bin_overflow):
        faults.append(f"bin_overflow {int(out.bin_overflow)} vs "
                      f"{int(ref.bin_overflow)}")
    if faults:
        raise AssertionError(f"{name}: the raster kernels disagree with the "
                             f"plain version: {'; '.join(faults)}")
    errors = {"raster_setup": setup_err, "raster_bin": bin_err,
              "raster_fwd": max(errs.values()), "raster_bwd": grad_err}
    return errors, int(out.bin_overflow), run


RASTER_REPLACES = {"raster_setup": "icon_tpu/ops/raster.py:106",
                   "raster_bin": "icon_tpu/ops/raster.py:49",
                   "raster_fwd": "icon_tpu/ops/raster.py:123",
                   "raster_bwd": "icon_tpu/ops/raster.py:123"}


def raster_kernel_times(ndc, faces, attrs, size, K, weights,
                        plain_reps: int = 10):
    """Each raster kernel alone on this input (:func:`kernel_ms` of its
    launches on preallocated buffers), the plain version of the same step
    (the per-face gathers, ``_bin_faces``, ``raster_plain`` forward; the
    median of ``plain_reps``), and each kernel's bound on this input's
    busy tiles. Returns {kernel: (ms, plain ms or None, bound ms, bound
    by)}."""
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
                                         ndc[:, 2][f], attrs[f]),
                                plain_reps),
        "raster_bin": cuda_ms(lambda: rk._bin_faces(
            tri_xy, tiles, tiles, rk.TILE, size, size, K), plain_reps),
        "raster_fwd": cuda_ms(lambda: rk.raster_plain(
            tri_xy, tri_z, tri_attr, fl, cn, size, size, rk.TILE, 1e-4, 16),
            plain_reps),
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


# phase 14: the geometry trainer and the evaluator at the published width
# (data/fixture.py:train_config: batch 4, 512^2, 8,000 samples an item)
TRAIN_SIZE, TRAIN_SAMPLES, TRAIN_BATCH = 512, 8000, 4
TRAIN_STEPS, RESUME_STEPS = 4, 6
# the small card-vs-CPU steps (c): the first step's loss (the same weights)
# to TRAIN_LOSS_RTOL; after a step a parameter may differ by up to the
# optimizer's largest move (RMSprop's |u| <= lr / sqrt(1 - 0.9)) where its
# gradient is at rounding level, so the later losses to TRAIN_LATER_RTOL;
# the median |d| of each parameter tensor to TRAIN_PARAM_MEDIAN, the
# BatchNorm statistics to TRAIN_BN_ATOL
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LATER_RTOL = 2e-3
TRAIN_BN_ATOL = 2e-3
TRAIN_PARAM_MEDIAN = 1e-5


def write_train_config(cfg, d: str) -> str:
    from icon_tpu_torch.config import save_config
    path = os.path.join(d, f"{cfg.name}.yaml")
    save_config(cfg, path)
    return path


def train_items_agree(dev, root):
    """[14b] The full-width dataset's items: labels balanced, and each
    item's ``smpl_query_inside`` (the host's ray parity) equal to
    ``ray_parity_inside`` on the card for the same points and body."""
    from icon_tpu_torch.data.datasets import PIFuDataset, projection_np
    from icon_tpu_torch.data.fixture import train_config
    from icon_tpu_torch.ops.sdf_fast import build_ray_bins, ray_parity_inside
    ds = PIFuDataset(train_config(root))
    for i in (0, len(ds) - 1):
        t0 = time.perf_counter()
        item = ds[i]
        t_item = time.perf_counter() - t0
        q = projection_np(item["sample"], item["calib"]).astype(np.float32)
        bins, grid = build_ray_bins(item["smpl_verts"], item["smpl_faces"],
                                    n_tiles=32)
        card = ray_parity_inside(
            torch.from_numpy(q).to(dev),
            torch.from_numpy(item["smpl_verts"]).to(dev),
            torch.from_numpy(item["smpl_faces"]).to(dev),
            torch.from_numpy(bins).to(dev), torch.from_numpy(grid).to(dev))
        differ = int((card.cpu().numpy() != item["smpl_query_inside"]).sum())
        inside = float(item["label"].mean())
        print(f"[14] item {i} ({item['subject']} rot {item['rotation']}, "
              f"{t_item:.2f} s on the host): {len(q)} samples, label inside "
              f"share {inside:.3f}, body inside share "
              f"{float(item['smpl_query_inside'].mean()):.3f}; card ray "
              f"parity differs from the dataset's at {differ}", flush=True)
        if differ or not 0.3 <= inside <= 0.7:
            raise AssertionError("phase 14 dataset item signs or balance")


def params_agree(a: dict, b: dict, lr: float, steps: int):
    """(largest |d| over every parameter, largest median |d| of a tensor,
    whether both hold the tolerance of the small steps)."""
    worst, med = 0.0, 0.0
    for k, v in a.items():
        d = (v.detach().cpu() - b[k].detach().cpu()).abs()
        worst = max(worst, float(d.max()))
        med = max(med, float(d.median()))
    return worst, med, worst <= steps * lr / (1 - 0.9) ** 0.5 * 1.01 and \
        med <= TRAIN_PARAM_MEDIAN


def train_small_agrees(dev, d):
    """[14c] A small train step on the card against the same on the CPU:
    a 64^2 fixture (2 subjects, 2 views), the narrow-width config, one
    batch of 2, the same initial weights; 3 RMSprop steps: the loss of each
    step, the parameters and BatchNorm statistics after them, then an eval
    step's loss."""
    import copy
    from icon_tpu_torch.data.datasets import PIFuDataset, collate
    from icon_tpu_torch.data.fixture import (fixture_config,
                                             make_synthetic_dataset)
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.training.train_step import (batch_to, eval_step,
                                                    make_optimizer,
                                                    train_step)
    root = os.path.join(d, "small")
    make_synthetic_dataset(root, n_subjects=2, n_views=2, size=64,
                           vis_res=256, device=dev)
    cfg = fixture_config(root, n_views=2, num_sample_geo=512, image_size=64)
    batch = collate([PIFuDataset(cfg)[i] for i in range(2)])
    torch.manual_seed(0)
    nets = {"cpu": HGPIFuNet(cfg, normal_net=False)}
    nets["card"] = copy.deepcopy(nets["cpu"]).to(dev)
    losses = {}
    for where, net in nets.items():
        opt = make_optimizer(net, cfg, steps_per_epoch=1)
        b = batch_to(batch, net.if_regressor.filters[0].weight.device)
        losses[where] = [float(train_step(net, opt, b)["loss"])
                         for _ in range(3)]
        losses[where].append(float(eval_step(net, b)["loss"]))
    first_err = abs(losses["card"][0] / losses["cpu"][0] - 1.0)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                       losses["cpu"]))
    sd = {w: n.state_dict() for w, n in nets.items()}
    names = [n for n, _ in nets["cpu"].named_parameters()]
    worst, med, ok = params_agree({k: sd["card"][k] for k in names},
                                  {k: sd["cpu"][k] for k in names},
                                  cfg.lr_G, 3)
    bn_err = max(float((sd["card"][k].cpu() - v).abs().max())
                 for k, v in sd["cpu"].items() if "running" in k)
    print(f"[14] small steps card vs CPU: losses {losses['card']} vs "
          f"{losses['cpu']} (rel {first_err:.3g} at the first, "
          f"{loss_err:.3g} at most), parameters max|d| "
          f"{worst:.3g} (bound {3 * cfg.lr_G / 0.1 ** 0.5:.3g}), largest "
          f"tensor median |d| {med:.3g}, BatchNorm stats max|d| {bn_err:.3g}",
          flush=True)
    if first_err > TRAIN_LOSS_RTOL or loss_err > TRAIN_LATER_RTOL or \
            not ok or bn_err > TRAIN_BN_ATOL:
        raise AssertionError("phase 14 small train steps: card and CPU "
                             "disagree")


def run_cli(argv, tag):
    """``apps/train.py:main`` in this process with the launch counts set to
    0 just before and read just after; returns (record, launches)."""
    from icon_tpu_torch.apps.train import main
    reset_launches()                  # count only the main path's launches
    record = main(argv)
    torch.cuda.synchronize()
    launched = read_launches()
    print(f"[14] {tag}: launches {launched}", flush=True)
    return record, launched


def phase_train(dev, card, d):
    """Phase 14: the geometry trainer and the evaluator on the card, in
    the directory ``d`` (its fixture under ``d/data``, which phase 15
    renders again). Returns (the launches of its main-path runs, {kernel:
    worst error})."""
    from icon_tpu_torch.data.fixture import (make_synthetic_dataset,
                                             train_config)
    runs, worst = [], dict.fromkeys(("knn_f32", "raster_setup",
                                     "raster_bin", "raster_fwd",
                                     "voxel_splat", "box_smooth3d"), 0.0)
    root = os.path.join(d, "data")
    t0 = time.perf_counter()
    reset_launches()              # count only the main path's launches
    make_synthetic_dataset(root, n_subjects=2, n_views=3,
                           size=TRAIN_SIZE, vis_res=1024, device=dev)
    torch.cuda.synchronize()
    runs.append(read_launches())
    print(f"[14] fixture 2 subjects x 3 views at {TRAIN_SIZE}^2, vis "
          f"1024^2: {time.perf_counter() - t0:.2f} s, launches "
          f"{runs[-1]}", flush=True)
    check_launched(runs[-1], ("raster_setup", "raster_bin",
                              "raster_fwd"), "phase 14 fixture")
    train_items_agree(dev, root)
    train_small_agrees(dev, d)

    cfg_path = write_train_config(
        train_config(root, d, num_epoch=RESUME_STEPS), d)
    knn_calls = []
    remove = knn_spy(knn_calls)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        rec, launched = run_cli(["-cfg", cfg_path, "--max_steps",
                                 str(TRAIN_STEPS)], "train")
    finally:
        remove()
    runs.append(launched)
    check_launched(launched, ("knn_f32",), "phase 14 train")
    losses = rec["losses"]
    print(f"[14] train CLI at full width (batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}^2, {TRAIN_SAMPLES} samples, 4 loader workers) "
          f"on {card}: {rec['steps']} steps in {rec['seconds']:.2f} s; "
          f"s/step cold {rec['step_s'][0]:.3f}, warm "
          f"{statistics.median(rec['step_s'][1:]):.4f} (median of "
          f"{len(rec['step_s']) - 1}); wait for a batch "
          f"{[round(w, 3) for w in rec['wait_s']]}; kNN launches a step "
          f"{launched['knn_f32'] / rec['steps']:.2f} (validation and "
          f"panels included); peak {rec['peak_gib']} GiB; losses "
          f"{losses}; val {rec['val_loss']}; checkpoints "
          f"{[os.path.basename(p) for p in rec['ckpts']]}; panels "
          f"{len(rec['panels'])}", flush=True)
    if rec["steps"] != TRAIN_STEPS or not np.isfinite(losses).all() \
            or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"phase 14: losses {losses}")
    kept = [p for p in rec["ckpts"] if os.path.exists(p)]
    panels = [p for p in rec["panels"] if os.path.getsize(p) > 0]
    print(f"[14] checkpoints kept (top 3 by val loss + latest): "
          f"{[os.path.basename(p) for p in kept]}, "
          f"{os.path.getsize(kept[-1]) / 2**20:.1f} MiB each; panels "
          f"written {len(panels)}", flush=True)
    if kept[-1] != rec["ckpts"][-1] or not 1 <= len(kept) <= 4 or \
            len(panels) != TRAIN_STEPS:
        raise AssertionError("phase 14: checkpoints or panels missing")

    rec2, launched = run_cli(["-cfg", cfg_path, "-resume", "--max_steps",
                              str(RESUME_STEPS)], "resume")
    runs.append(launched)
    print(f"[14] resume: from step {rec2['start_step']} to "
          f"{rec2['steps']}, losses {rec2['losses']}", flush=True)
    if rec2["start_step"] != TRAIN_STEPS or \
            rec2["steps"] != RESUME_STEPS or \
            not np.isfinite(rec2["losses"]).all():
        raise AssertionError("phase 14: resume did not continue")

    remove = knn_spy(knn_calls)
    try:
        rec3, launched = run_cli(["-cfg", cfg_path, "-test",
                                  "--max_eval_items", "2"], "eval")
    finally:
        remove()
    runs.append(launched)
    check_launched(launched, ("knn_f32", "raster_setup", "raster_bin",
                              "raster_fwd"), "phase 14 eval")
    items = rec3["items"]
    for r in items:
        print(f"[14] eval {r['subject']} rot {r['rotation']}: chamfer "
              f"{r['chamfer']:.4f} P2S {r['p2s']:.4f} NC {r['NC']:.4f}, "
              f"levels {r['levels']}, {r['n_tris']} tris, {r['s']:.3f} "
              f"s/item", flush=True)
    if len(items) != 2 or not all(
            np.isfinite([r["chamfer"], r["p2s"], r["NC"]]).all()
            for r in items):
        raise AssertionError("phase 14: eval metrics missing or "
                             "non-finite")

    voxel_calls = []
    remove = voxel_spy(voxel_calls)
    try:
        pcfg = write_train_config(
            train_config(root, d, "pamir", num_epoch=RESUME_STEPS), d)
        rec4, launched = run_cli(["-cfg", pcfg, "--max_steps", "2"],
                                 "pamir train")
    finally:
        remove()
    runs.append(launched)
    check_launched(launched, ("voxel_splat", "box_smooth3d"),
                   "phase 14 pamir train")
    print(f"[14] pamir train: {rec4['steps']} steps, losses "
          f"{rec4['losses']}, s/step {rec4['step_s']}, voxelize "
          f"launches a step {launched['voxel_splat'] / rec4['steps']:.2f}"
          f" (validation and panels included)", flush=True)
    if not np.isfinite(rec4["losses"]).all():
        raise AssertionError("phase 14: pamir losses")
    worst.update(train_kernels_agree(dev, root, knn_calls, voxel_calls,
                                     items))
    return runs, worst


def train_kernels_agree(dev, root, knn_calls, voxel_calls, items):
    """[14g] The kernels against their plain versions on phase 14's own
    inputs: up to 24 of the recorded kNN calls (the train steps' and the
    eval's), every voxelize launch of the pamir run, the raster forward on
    the fixture's first scan at 512^2 (K=256), its body's visibility raster
    at 1024^2 (K=512), and the evaluator's normal render of each item's
    reconstruction. Returns {kernel: worst error}."""
    from icon_tpu_torch.kernels import knn
    from icon_tpu_torch.render.camera import verts_to_ndc
    from icon_tpu_torch.utils.io import load_obj
    worst = {}
    pick = np.unique(np.linspace(0, len(knn_calls) - 1,
                                 min(24, len(knn_calls))).astype(int))
    for i in pick:
        pts, verts, k = knn_calls[i]
        idx, key = knn.nearest_vertices_kernel(pts, verts, k)
        torch.cuda.synchronize()
        rel, same, _, _, key0 = knn_picks_agree(idx, key, pts, verts, k)
        if rel > KEY_RTOL or not same:
            raise AssertionError(f"phase 14 kNN call {i} disagrees")
        worst["knn_f32"] = max(worst.get("knn_f32", 0.0),
                               float((key - key0).abs().max()))
    print(f"[14] kNN kernel vs plain on {len(pick)} of {len(knn_calls)} "
          f"calls (N {sorted({len(knn_calls[i][0]) for i in pick})}): keys "
          f"and picks agree, max|dkey| {worst.get('knn_f32', 0.0):.3g}",
          flush=True)
    for name, args in voxel_calls:
        err, ok, note = voxel_agrees(name, args)
        print(f"[14] {name} vs plain on the pamir run's input: max|d| "
              f"{err:.3g}, {note}", flush=True)
        if not ok:
            raise AssertionError(f"phase 14 {name} disagrees")
        worst[name] = max(worst.get(name, 0.0), err)
    rng = np.random.RandomState(14)
    v, f = load_obj(os.path.join(root, "synth", "scans", "0000",
                                 "0000.obj"))
    v = torch.from_numpy(v).to(dev)
    f = torch.from_numpy(np.asarray(f)).long().to(dev)
    cases = [("scan normal 0", normal_inputs(v, f, 0.0), 512, 256),
             ("scan visibility", (verts_to_ndc(v), f, v.new_zeros(
                 (len(v), 1))), 1024, 512)]
    for r in items:
        mv, mf = r["meshes"][0]
        mv = torch.as_tensor(mv, dtype=torch.float32, device=dev)
        mf = torch.as_tensor(np.asarray(mf), dtype=torch.int64, device=dev)
        cases.append((f"eval NC {r['subject']} {r['rotation']}",
                      normal_inputs(mv, mf, 0.0), 512, 256))
    for name, (ndc, faces, attrs), res, K in cases:
        errs, _, _ = compare_raster("[14]", f"{name} {res}^2", ndc, faces,
                                    attrs, res, K, rng, backward=False)
        for k in ("raster_setup", "raster_bin", "raster_fwd"):
            worst[k] = max(worst.get(k, 0.0), errs[k])
    return worst


RENDER_VIEWS, RENDER_SIZE, PRT_DIRS, VIS_RES = 36, 512, 64, 4096
PRT_RES = 512                   # compute_prt's depth rasters, as render_one
RENDER_DIRS = ("calib", "render", "normal_F", "normal_B", "T_normal_F",
               "T_normal_B", "vis")
# compute_prt on the card against the CPU, 16 directions at the PRT's
# 512^2: T to PRT_CARD_ATOL on all but PRT_FLIP_SHARE of the vertices,
# whose visibility may flip a PCF texel where a depth sits at the eps edge
# (vertex normals that round otherwise on the card); those within one
# direction's whole term, 4 / 16 (|Y_lm| < 1)
PRT_CHECK_DIRS = 16
PRT_CARD_ATOL = 1e-5
PRT_FLIP_SHARE = 5e-3
NORMAL_STEPS, NORMAL_RESUME, NORMAL_BATCH, NORMAL_LR = 6, 8, 4, 2e-4
# three narrow Adam steps card vs CPU (tests/test_torch_normal_train.py's
# bounds): the first loss to 1e-5 relative, the later ones to 1e-4, every
# parameter within 2 lr a step (noise-level gradients), each tensor's
# median to 1e-2 lr
NORMAL_SMALL_MEDIAN = 1e-2
# poisson_reconstruct at res 64 card vs CPU: the float32 CG drifts apart
# with the order of its sums (the card's splat adds by atomics), and the
# level set moves by that drift over chi's gradient, far where the field is
# flat; so the counts to 1% and every vertex within one grid cell of the
# other mesh (0.569 cells measured at the first run)
POISSON_RES, POISSON_COUNT_RTOL, POISSON_CELLS = 64, 0.01, 1.0


def raster_spy(calls: list):
    """A pass-through spy on the raster kernels' wrapper that records each
    call's inputs (cloned) in ``calls`` as (ndc, faces, attrs, size, K)
    and counts nothing; returns a function that removes it."""
    from icon_tpu_torch.kernels import raster as rk
    kernel = rk.rasterize

    def spy(verts_ndc, faces, attrs, H, W, *args):
        calls.append((verts_ndc.detach().clone(), faces.detach().clone(),
                      attrs.detach().clone(), H, args[1]))
        return kernel(verts_ndc, faces, attrs, H, W, *args)

    rk.rasterize = spy

    def remove():
        rk.rasterize = kernel
    return remove


def render_argv(root: str, procs: int) -> list:
    return ["-root", root, "-dataset", "synth", "-views", str(RENDER_VIEWS),
            "-size", str(RENDER_SIZE), "-prt", "-prt_dirs", str(PRT_DIRS),
            "-vis_res", str(VIS_RES), "-procs", str(procs)]


def rendered_files(recs) -> dict:
    """{subject: sorted relative paths under its output folder}; raises
    unless every subject rendered with its body and wrote the full set."""
    want = sorted(f"{k}/{y:03d}." + {"calib": "txt", "vis": "npy"}.get(
        k, "png") for k in RENDER_DIRS for y in range(0, 360,
                                                      360 // RENDER_VIEWS))
    out = {}
    for r in recs:
        if r["status"] != "rendered" or not r["body"]:
            raise AssertionError(f"phase 15: subject {r['subject']}: {r}")
        out[r["subject"]] = sorted(
            os.path.relpath(os.path.join(dp, f), r["out_dir"])
            for dp, _, fs in os.walk(r["out_dir"]) for f in fs)
        if out[r["subject"]] != want:
            raise AssertionError(f"phase 15: {r['subject']}'s files")
    return out


def render_diff(recs_a, recs_b, files) -> dict:
    """{kind: files of two render runs (same subjects, ``files`` from
    :func:`rendered_files`) that are not byte-equal}; prints each kind's
    largest difference of the decoded values where any differ."""
    from PIL import Image
    load = {"png": lambda f: np.asarray(Image.open(f), np.int64),
            "npy": np.load, "txt": np.loadtxt}
    diff, worst = dict.fromkeys(RENDER_DIRS, 0), dict.fromkeys(RENDER_DIRS,
                                                               0.0)
    for a, b in zip(recs_a, recs_b):
        for rel in files[a["subject"]]:
            fa, fb = (os.path.join(r["out_dir"], rel) for r in (a, b))
            with open(fa, "rb") as x, open(fb, "rb") as y:
                if x.read() == y.read():
                    continue
            kind = rel.split("/")[0]
            diff[kind] += 1
            read = load[rel.rsplit(".", 1)[1]]
            worst[kind] = max(worst[kind], float(np.abs(
                read(fa).astype(np.float64) - read(fb)).max()))
    if any(diff.values()):
        print(f"[15] largest difference of the decoded values by kind: "
              f"{ {k: v for k, v in worst.items() if diff[k]} }", flush=True)
    return diff


def visible_vertices(pix_to_face, faces, n_verts) -> torch.Tensor:
    """``vertex_visibility``'s vertex set from a pix_to_face image."""
    pf = pix_to_face.reshape(-1)
    fv = faces[pf[pf >= 0]].reshape(-1)
    vis = torch.zeros(n_verts, dtype=torch.bool, device=faces.device)
    vis[fv] = True
    return vis


def render_kernels_agree(calls, recs, rng):
    """[15b] The raster kernels against the plain version on the render
    run's own inputs: of each raster kind, the first and the last call
    (the scan's 6-channel normal and PRT-irradiance renders and the body's
    normal renders at 512^2 K=256, the 4096^2 K=512 visibility, the PRT
    depth rasters at 512^2 K=512) as in phase 7, forward only; for the
    visibility also the vertex set against the plain raster's and against
    the run's own ``vis/*.npy``. Returns ({kernel: worst error}, the calls
    by kind)."""
    from icon_tpu_torch.ops.raster import rasterize_plain
    kinds = {
        "scan normal+irradiance 512^2 K=256": lambda c: c[3] == RENDER_SIZE
        and c[4] == 256 and c[2].shape[1] == 6,
        "body normal 512^2 K=256": lambda c: c[3] == RENDER_SIZE
        and c[4] == 256 and c[2].shape[1] == 3,
        f"visibility {VIS_RES}^2 K=512": lambda c: c[3] == VIS_RES,
        "PRT depth 512^2 K=512": lambda c: c[3] == PRT_RES and c[4] == 512}
    per_subject = dict(zip(kinds, (2 * RENDER_VIEWS, 2 * RENDER_VIEWS,
                                   RENDER_VIEWS, PRT_DIRS)))
    by_kind = {k: [c for c in calls if test(c)] for k, test in kinds.items()}
    print("[15] raster calls of the render run: " + ", ".join(
        f"{k} {len(v)}" for k, v in by_kind.items()), flush=True)
    if any(len(by_kind[k]) != per_subject[k] * len(recs) for k in kinds) \
            or sum(map(len, by_kind.values())) != len(calls):
        raise AssertionError("phase 15: raster calls of the render run")
    worst = {}
    for kind, cs in by_kind.items():
        for i in (0, len(cs) - 1):
            ndc, faces, attrs, size, K = cs[i]
            errs, _, _ = compare_raster("[15]", f"{kind} call {i}", ndc,
                                        faces, attrs, size, K, rng,
                                        backward=False)
            for k in ("raster_setup", "raster_bin", "raster_fwd"):
                worst[k] = max(worst.get(k, 0.0), errs[k])
            if size != VIS_RES:
                continue
            # call i of the visibility is view i % 36 of subject i // 36
            rec = recs[i // RENDER_VIEWS]
            y = (i % RENDER_VIEWS) * (360 // RENDER_VIEWS)
            with torch.no_grad():
                ref = rasterize_plain(ndc, faces, attrs, H=size, W=size, K=K)
            vis = visible_vertices(ref.pix_to_face, faces, len(ndc))
            saved = np.load(os.path.join(rec["out_dir"], "vis",
                                         f"{y:03d}.npy"))[:, 0] > 0
            same = bool((vis.cpu().numpy() == saved).all())
            print(f"[15] {rec['subject']} view {y:03d}: the run's vertex "
                  f"visibility ({int(saved.sum())} of {len(saved)} visible) "
                  f"equals the plain raster's: {same}", flush=True)
            if not same:
                raise AssertionError("phase 15: visibility vertex sets")
    return worst, by_kind


def render_kernel_times(by_kind, rng):
    """[15c] Each raster kernel alone at the new shapes (the first
    visibility call at 4096^2 K=512, the first PRT depth raster at 512^2
    K=512) beside its bound and the plain version's time (3 runs at
    4096^2)."""
    out = {}
    for kind, reps in ((f"visibility {VIS_RES}^2 K=512", 3),
                       ("PRT depth 512^2 K=512", 10)):
        ndc, faces, attrs, size, K = by_kind[kind][0]
        weights = [torch.from_numpy(rng.randn(*shape).astype(
            np.float32)).to(ndc.device) for shape in (
            (size, size, attrs.shape[1]), (size, size), (size, size))]
        kern = raster_kernel_times(ndc, faces, attrs, size, K, weights,
                                   plain_reps=reps)
        out[kind] = kern
        print(f"[15] kernels alone at {kind} ({len(faces)} faces): "
              + "; ".join(f"{k} {m:.4f} ms (plain "
                          + ("n/a" if p is None else f"{p:.4f}")
                          + f", bound {b:.4f} ms by {by}, {b / m:.1%} of "
                          f"it)" for k, (m, p, b, by) in kern.items()),
              flush=True)
    return out


def prt_card_agrees(dev, root, subject):
    """[15d] ``compute_prt`` of a subject's normalized scan on the card
    against the CPU (PRT_CHECK_DIRS directions at 512^2)."""
    from icon_tpu_torch.apps.render import load_subject
    from icon_tpu_torch.data.render_dataset import compute_prt
    scan_v, scan_f, _, _ = load_subject(root, "synth", subject, dev)
    t0 = time.perf_counter()
    card = compute_prt(scan_v, scan_f, n_dirs=PRT_CHECK_DIRS, device=dev)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = compute_prt(scan_v, scan_f, n_dirs=PRT_CHECK_DIRS, device="cpu")
    t_cpu = time.perf_counter() - t0
    d = np.abs(card - cpu).max(1)
    flips = float((d > PRT_CARD_ATOL).mean())
    print(f"[15] compute_prt {subject} ({len(scan_v)} vertices, "
          f"{PRT_CHECK_DIRS} dirs at 512^2) card vs CPU: max|dT| "
          f"{d.max():.3g}, share of vertices beyond {PRT_CARD_ATOL} "
          f"{flips:.4f}; card {t_card:.3f} s, CPU {t_cpu:.3f} s",
          flush=True)
    if flips > PRT_FLIP_SHARE or d.max() > 4.0 / PRT_CHECK_DIRS:
        raise AssertionError("phase 15: compute_prt card vs CPU")


def render_split(dev, root, subject):
    """[15e] One subject's render at the same settings under
    ``torch.profiler``: the wall time, the PRT, the PNG encodes and writes
    (a timer around ``render_dataset._save_png``) and the device's kernel
    time, so its busy share."""
    from torch.profiler import ProfilerActivity, profile
    from icon_tpu_torch.apps.render import render_one
    from icon_tpu_torch.data import render_dataset
    save, png = render_dataset._save_png, [0.0]

    def timed_save(*args):
        t0 = time.perf_counter()
        save(*args)
        png[0] += time.perf_counter() - t0

    render_dataset._save_png = timed_save
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rec = render_one(root, "synth", subject, RENDER_VIEWS,
                             RENDER_SIZE, PRT_DIRS, VIS_RES, 0, dev)
    finally:
        render_dataset._save_png = save
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    print(f"[15] render split of {subject} under the profiler: "
          f"{rec['seconds']:.2f} s, PRT {rec['prt_s']:.3f} s, PNG encodes "
          f"and writes {png[0]:.2f} s ({5 * RENDER_VIEWS} files), device "
          f"kernels {busy:.3f} s ({busy / rec['seconds']:.2%} busy); "
          f"busiest: " + ", ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
              for e in top), flush=True)


def normal_config(root: str, ckpt_dir: str):
    """The NormalNet's published training widths (reference
    configs/train/normal.yaml: ngf 64, 4 downsamplings, 9 resblocks, batch
    4 at 512^2, lr_N 2e-4) on the rendered ``synth_36views``, 4 loader
    workers."""
    from icon_tpu_torch.config import Config, DatasetConfig, NetConfig
    return Config(
        name="normal", ckpt_dir=ckpt_dir, batch_size=NORMAL_BATCH,
        num_threads=4, num_epoch=10, lr_N=NORMAL_LR,
        net=NetConfig(in_nml=(("image", 3), ("T_normal_F", 3),
                              ("T_normal_B", 3)),
                      ngf=64, n_downsampling=4, n_blocks=9),
        dataset=DatasetConfig(root=root, types=("synth",), scales=(1.0,),
                              rotation_num=RENDER_VIEWS,
                              input_size=RENDER_SIZE))


def normal_small_agrees(dev, cfg, batch):
    """[15f] Three Adam steps of a narrow NormalNet (ngf 8, 2
    downsamplings, 1 resblock) on two rendered 512^2 items, on the card
    against the CPU from the same weights."""
    import copy
    from icon_tpu_torch.models.normalnet import NormalNet
    from icon_tpu_torch.training.normal_step import (make_normal_optimizer,
                                                     normal_train_step)
    from icon_tpu_torch.training.train_step import batch_to
    torch.manual_seed(0)
    nets = {"cpu": NormalNet(ngf=8, n_downsampling=2, n_blocks=1)}
    nets["card"] = copy.deepcopy(nets["cpu"]).to(dev)
    losses = {}
    for where, net in nets.items():
        opt = make_normal_optimizer(net, cfg, steps_per_epoch=18)
        b = batch_to(batch, next(net.parameters()).device)
        losses[where] = [float(normal_train_step(net, opt, b)["loss"])
                         for _ in range(3)]
    rel = [abs(a / b - 1.0) for a, b in zip(losses["card"], losses["cpu"])]
    sd = {w: n.state_dict() for w, n in nets.items()}
    worst = max(float((sd["card"][k].cpu() - v).abs().max())
                for k, v in sd["cpu"].items())
    med = max(float((sd["card"][k].cpu() - v).abs().median())
              for k, v in sd["cpu"].items() if not k.endswith(".bias"))
    print(f"[15] small NormalNet steps card vs CPU: losses {losses['card']}"
          f" vs {losses['cpu']} (rel {[f'{r:.3g}' for r in rel]}), "
          f"parameters max|d| {worst:.3g} (bound {6 * NORMAL_LR:.3g}), "
          f"largest weight median |d| {med:.3g}", flush=True)
    if rel[0] > 1e-5 or max(rel) > 1e-4 or worst > 6 * NORMAL_LR * 1.01 \
            or med > NORMAL_SMALL_MEDIAN * NORMAL_LR:
        raise AssertionError("phase 15 small NormalNet steps")


def normal_step_modes(dev, cfg, batch) -> dict:
    """[15g] One full-width NormalNet step on one batch, CUDA-event median
    of 3 after one, with TF32 off (the parity setting), off with
    ``cudnn.benchmark``, and on (torch's default for convolutions); the
    peak memory of the step."""
    from icon_tpu_torch.apps.train_normal import build_normal_net
    from icon_tpu_torch.training.normal_step import (make_normal_optimizer,
                                                     normal_train_step)
    net = build_normal_net(cfg, dev)
    opt = make_normal_optimizer(net, cfg, steps_per_epoch=18)

    def step():
        normal_train_step(net, opt, batch)

    torch.cuda.reset_peak_memory_stats(dev)
    out = {"tf32_off": cuda_ms(step, 3)}
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.backends.cudnn.benchmark = True
    out["tf32_off_benchmark"] = cuda_ms(step, 3)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["tf32_on"] = cuda_ms(step, 3)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"[15] full-width NormalNet step (batch {NORMAL_BATCH}, "
          f"{RENDER_SIZE}^2): TF32 off {out['tf32_off']:.1f} ms, off with "
          f"cudnn.benchmark {out['tf32_off_benchmark']:.1f} ms, TF32 on "
          f"{out['tf32_on']:.1f} ms; peak {out['peak_gib']:.2f} GiB",
          flush=True)
    return out


def run_normal_cli(argv, tag):
    """``apps/train_normal.py:main`` in this process; returns its
    record."""
    from icon_tpu_torch.apps.train_normal import main
    rec = main(argv)
    torch.cuda.synchronize()
    print(f"[15] {tag}: {rec['steps']} steps from {rec['start_step']}, "
          f"losses {[round(x, 4) for x in rec['losses']]}, val "
          f"{rec['val_loss']} (VGG term {rec['vgg']})", flush=True)
    return rec


def phase_normal_train(dev, card, root, d):
    """[15f-h] The NormalNet trainer on the rendered ``synth_36views``."""
    from icon_tpu_torch.data.datasets import NormalDataset, collate
    from icon_tpu_torch.training.train_step import batch_to
    from icon_tpu_torch.utils.synthetic import write_vgg19
    cfg = normal_config(root, d)
    cfg_path = write_train_config(cfg, d)
    t0 = time.perf_counter()
    vgg = write_vgg19(os.path.join(d, "vgg", "vgg19.pth"), seed=15)
    print(f"[15] seeded VGG19 in torchvision's layout: "
          f"{os.path.getsize(vgg) / 2**20:.0f} MiB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ds = NormalDataset(cfg)
    normal_small_agrees(dev, cfg, collate([ds[0], ds[len(ds) - 1]]))
    modes = normal_step_modes(dev, cfg, batch_to(
        collate([ds[i] for i in range(NORMAL_BATCH)]), dev))

    torch.cuda.reset_peak_memory_stats(dev)
    rec = run_normal_cli(["-cfg", cfg_path, "--max_steps",
                          str(NORMAL_STEPS), "--vgg_ckpt", vgg], "train")
    losses = rec["losses"]
    print(f"[15] train_normal CLI at full width (batch {NORMAL_BATCH}, "
          f"{RENDER_SIZE}^2, 4 loader workers) on {card}: {rec['steps']} "
          f"steps in {rec['seconds']:.2f} s; s/step cold "
          f"{rec['step_s'][0]:.3f}, warm "
          f"{statistics.median(rec['step_s'][1:]):.4f} (median of "
          f"{len(rec['step_s']) - 1}); wait for a batch "
          f"{[round(w, 3) for w in rec['wait_s']]}; peak "
          f"{rec['peak_gib']} GiB; checkpoints "
          f"{[os.path.basename(p) for p in rec['ckpts']]}; panels "
          f"{len(rec['panels'])}", flush=True)
    if rec["steps"] != NORMAL_STEPS or not np.isfinite(losses).all() \
            or not np.mean(losses[-3:]) < losses[0] or not rec["vgg"] \
            or not np.isfinite(rec["val_loss"]).all():
        raise AssertionError(f"phase 15 train_normal: {rec}")
    panels = [p for p in rec["panels"] if os.path.getsize(p) > 0]
    if len(panels) != NORMAL_STEPS:
        raise AssertionError("phase 15 train_normal: panels missing")
    rec2 = run_normal_cli(["-cfg", cfg_path, "-resume", "--max_steps",
                           str(NORMAL_RESUME), "--vgg_ckpt", vgg], "resume")
    kept = sorted(p for p in os.listdir(os.path.join(d, "normal"))
                  if p.endswith(".pt"))
    print(f"[15] checkpoints kept (top 3 by val loss + latest): {kept}",
          flush=True)
    if rec2["start_step"] != NORMAL_STEPS or \
            rec2["steps"] != NORMAL_RESUME or \
            not np.isfinite(rec2["losses"]).all() or \
            not 1 <= len(kept) <= 4 or \
            os.path.basename(rec2["ckpts"][-1]) not in kept:
        raise AssertionError("phase 15 train_normal: resume")
    return {"modes": modes, "train": rec, "resume": rec2}


def phase_surface_tools(dev, root, d):
    """[15i] ``poisson_reconstruct`` of the fixture's first scan on the
    card against the CPU at res 64, then on the card at its default res
    128; ``apps.tetrahedronize`` on a SMPL release pickle of the synthetic
    body, read back by the tetra loader."""
    from scipy.spatial import cKDTree
    from icon_tpu_torch.apps import tetrahedronize
    from icon_tpu_torch.models.smplx.assets import get_smpl_model
    from icon_tpu_torch.models.smplx.tetra import load_tetra_body_model
    from icon_tpu_torch.ops.poisson import poisson_reconstruct
    from icon_tpu_torch.utils.io import load_obj
    from icon_tpu_torch.utils.synthetic import write_smpl_pkl
    v, f = load_obj(os.path.join(root, "synth", "scans", "0000",
                                 "0000.obj"))
    out, secs = {}, {}
    for where, res in (("card", POISSON_RES), ("cpu", POISSON_RES),
                       ("card128", 128)):
        t0 = time.perf_counter()
        out[where] = poisson_reconstruct(
            v, f, res=res, device="cpu" if where == "cpu" else dev)
        torch.cuda.synchronize()
        secs[where] = time.perf_counter() - t0
    cell = float((v.max(0) - v.min(0)).max()) * 1.16 / POISSON_RES
    (cv, cf), (hv, hf) = out["card"], out["cpu"]
    dist = np.concatenate([cKDTree(cv).query(hv)[0],
                           cKDTree(hv).query(cv)[0]]) / cell
    count_err = max(abs(len(cv) / len(hv) - 1), abs(len(cf) / len(hf) - 1))
    print(f"[15] poisson_reconstruct of scan 0000 ({len(f)} faces) at res "
          f"{POISSON_RES}: card {len(cv)} verts {len(cf)} faces in "
          f"{secs['card']:.2f} s, CPU {len(hv)} verts {len(hf)} faces in "
          f"{secs['cpu']:.2f} s; vertex to the other mesh, in cells: median "
          f"{np.median(dist):.4f}, 99% {np.percentile(dist, 99):.4f}, max "
          f"{dist.max():.4f}; at res 128 on the card "
          f"{len(out['card128'][0])} verts in {secs['card128']:.2f} s",
          flush=True)
    if count_err > POISSON_COUNT_RTOL or dist.max() > POISSON_CELLS \
            or not len(out["card128"][1]):
        raise AssertionError("phase 15 poisson card vs CPU")
    body = get_smpl_model()
    pkl = write_smpl_pkl(os.path.join(d, "smpl", "SMPL_MALE.pkl"), body)
    t0 = time.perf_counter()
    npz = tetrahedronize.main(["-models", os.path.dirname(pkl), "-out",
                               os.path.join(d, "tedra")])["male"]
    t_tet = time.perf_counter() - t0
    model, extras = load_tetra_body_model(pkl, npz)
    n = len(body.v_template)
    added = len(model.v_template) - n
    with torch.no_grad():
        rest, _ = model(betas=torch.zeros(1, 10))
    rest_err = float((rest[0] - model.v_template).abs().max())
    print(f"[15] tetrahedronize of the synthetic body ({n} vertices): "
          f"+{added} interior nodes, {len(extras['tetrahedrons'])} tets in "
          f"{t_tet:.2f} s; the loader's rest pose max|d| {rest_err:.3g}",
          flush=True)
    if extras["n_surface"] != n or added < 20 or rest_err > 1e-5 or \
            not len(extras["tetrahedrons"]):
        raise AssertionError("phase 15 tetrahedronize")


def phase_render_normal(dev, card, d):
    """Phase 15: the dataset renderer at the reference's settings on phase
    14's scans and fits, its raster kernels against the plain version on
    the run's own inputs and alone at the new shapes, the NormalNet
    trainer on the renders, and the surface tools. Returns (the launches
    of the render run, {kernel: worst error})."""
    from icon_tpu_torch.apps import render
    root = os.path.join(d, "data")
    calls = []
    remove = raster_spy(calls)
    try:
        reset_launches()              # count only the main path's launches
        t0 = time.perf_counter()
        recs = render.main(render_argv(root, 1))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_launches()
    finally:
        remove()
    files = rendered_files(recs)
    print(f"[15] render CLI ({RENDER_VIEWS} views at {RENDER_SIZE}^2, PRT "
          f"{PRT_DIRS} dirs, visibility {VIS_RES}^2, -procs 1) on {card}: "
          f"{len(recs)} subjects in {seconds:.2f} s; per subject "
          + ", ".join(f"{r['subject']} {r['seconds']:.2f} s (PRT "
                      f"{r['prt_s']:.2f} s)" for r in recs)
          + f"; {sum(map(len, files.values()))} files; launches {launched}"
          f" ({launched['raster_fwd'] / len(recs):.0f} a subject)",
          flush=True)
    check_launched(launched, ("raster_setup", "raster_bin", "raster_fwd"),
                   "phase 15 render")
    rng = np.random.RandomState(15)
    worst, by_kind = render_kernels_agree(calls, recs, rng)
    del calls
    render_kernel_times(by_kind, rng)
    del by_kind
    prt_card_agrees(dev, root, recs[0]["subject"])

    # the same subjects again through a spawn pool of 2 workers, into a
    # second root that holds the same scans and fits
    root2 = os.path.join(d, "data_procs2")
    os.makedirs(os.path.join(root2, "synth"))
    for sub in ("scans", "fits"):
        os.symlink(os.path.join(root, "synth", sub),
                   os.path.join(root2, "synth", sub))
    t0 = time.perf_counter()
    recs2 = render.main(render_argv(root2, 2))
    seconds2 = time.perf_counter() - t0
    files2 = rendered_files(recs2)
    diff = render_diff(recs, recs2, files)
    print(f"[15] render CLI -procs 2: {len(recs2)} subjects in "
          f"{seconds2:.2f} s; file sets equal: {files2 == files}; files "
          f"not byte-equal to the -procs 1 run's: {sum(diff.values())} of "
          f"{sum(map(len, files.values()))} {diff}", flush=True)
    if files2 != files or any(diff.values()):
        raise AssertionError("phase 15: -procs 2 files differ from -procs 1")
    render_split(dev, root2, recs[0]["subject"])

    phase_normal_train(dev, card, root, d)
    phase_surface_tools(dev, root, d)
    return [launched], worst


# phase 16: data-parallel training and point-sharded recon. Two ranks share
# the one card over gloo (NCCL refuses two ranks on one card): each takes 2
# of the 4 items of the same global batches, from the same initial weights,
# against one process on the whole batch. The first loss to DIST_LOSS_RTOL,
# the BatchNorm running statistics after the first step to DIST_BN_RTOL of
# their layer's largest statistic (a running mean near 0 carries the
# float32 rounding of sums over the layer's whole batch, 1e-7 of its
# variance's scale, not of itself), the parameters after the last step as
# phase 14's small steps are held (RMSprop: every one within the
# optimizer's largest move, each tensor's median to TRAIN_PARAM_MEDIAN)
DIST_STEPS, DIST_PAMIR_STEPS = 3, 1
DIST_LOSS_RTOL = 1e-4
DIST_BN_RTOL = 1e-5
# the sharded frame's occupancy against the unsharded frame's
SHARD_OCC_ATOL = 1e-5
EXACT_RES = (33, 65, 129, 257)


def dist_batches(root, prior, n):
    """(config, the first global batch of each of epochs 0 .. n-1) of the
    training split of phase 14's fixture: batch 4, made by 4 loader
    workers."""
    from icon_tpu_torch.data.datasets import (PIFuDataset, close_iter,
                                              make_loader)
    from icon_tpu_torch.data.fixture import train_config
    cfg = train_config(root, prior=prior)
    loader = make_loader(PIFuDataset(cfg), batch_size=TRAIN_BATCH,
                         num_workers=4)
    batches = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        it = iter(loader)
        try:
            batches.append(next(it))
        finally:
            close_iter(it)
    return cfg, batches


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_steps(path, steps, dev):
    """``steps`` train steps of the saved job (``path``: config, initial
    state, global batches) on ``dev``, on this rank's slice of each batch
    (the whole batch without a group): losses, seconds a step, the
    BatchNorm statistics after the first step, the parameters after the
    last, the kernels' launches, peak memory, the gradient all-reduce's
    bytes and ms (several ranks only), and the kNN kernel and each voxelize
    kernel against its plain version on its first and last call."""
    from icon_tpu_torch.kernels import knn
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.parallel import dist
    from icon_tpu_torch.parallel.mesh import shard_batch
    from icon_tpu_torch.training.train_step import (batch_to, make_optimizer,
                                                    train_step)
    job = torch.load(path, weights_only=False)
    net = HGPIFuNet(job["cfg"], normal_net=False).to(dev)
    net.load_state_dict(job["state"])
    opt = make_optimizer(net, job["cfg"], steps_per_epoch=100)
    calls, voxel_calls = [], []
    remove, remove_voxel = knn_spy(calls), voxel_spy(voxel_calls)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()               # count only the main path's launches
    out = {"losses": [], "step_s": [], "rank": dist.rank(),
           "world": dist.world()}
    try:
        for i in range(steps):
            b = batch_to(shard_batch(job["batches"][i], dist.rank(),
                                     dist.world()), dev)
            sync(dev)
            t0 = time.perf_counter()
            out["losses"].append(float(train_step(net, opt, b)["loss"]))
            sync(dev)
            out["step_s"].append(time.perf_counter() - t0)
            if i == 0:
                out["bn1"] = {k: v.cpu() for k, v in
                              net.state_dict().items() if "running" in k}
    finally:
        remove()
        remove_voxel()
    out["launched"] = read_launches()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    out["params"] = {k: p.detach().cpu() for k, p in net.named_parameters()}
    out["bytes"], out["reduce_ms"] = 0, None
    if dist.world() > 1:          # the last step's gradients, reduced again
        times = []
        for _ in range(5):
            sync(dev)
            t0 = time.perf_counter()
            out["bytes"] = dist.all_reduce_mean_grads(net)
            sync(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        out["reduce_ms"] = statistics.median(times)
    out["knn_calls"], out["knn_err"] = len(calls), 0.0
    for pts, verts, k in (calls[0], calls[-1]) if calls else ():
        idx, key = knn.nearest_vertices_kernel(pts, verts, k)
        sync(dev)
        rel, same, _, _, key0 = knn_picks_agree(idx, key, pts, verts, k)
        if rel > KEY_RTOL or not same:
            raise AssertionError(f"rank {dist.rank()}: the kNN kernel "
                                 "disagrees with plain on a step's call")
        out["knn_err"] = max(out["knn_err"], float((key - key0).abs().max()))
    out["voxel_err"] = {}
    for name in VOXEL_REPLACES:
        args = [a for c, a in voxel_calls if c == name]
        if len(args) != out["launched"][name]:
            raise AssertionError(f"{len(args)} {name} calls recorded, "
                                 f"{out['launched'][name]} launched")
        for a in (args[0], args[-1]) if args else ():
            err, ok, note = voxel_agrees(name, a)
            if not ok:
                raise AssertionError(f"rank {dist.rank()}: {name} disagrees "
                                     f"with plain on a step's call: {note}")
            out["voxel_err"][name] = max(out["voxel_err"].get(name, 0.0), err)
    return out


def dist_rank(rank, port, backend, devices, jobs, out):
    """One rank of phase 16: the jobs' steps on ``devices[rank]`` in a
    group of ``len(devices)`` ranks over ``backend`` (gloo, or None: the
    default, NCCL for cards of their own); writes its results to
    ``{out}.{rank}``."""
    from icon_tpu_torch.parallel import dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = devices[rank]
    dist.initialize_distributed(f"127.0.0.1:{port}", len(devices), rank,
                                backend=backend, device=dev)
    try:
        res = [dist_steps(path, steps, dev) for path, steps in jobs]
        res[0]["backend"] = torch.distributed.get_backend() \
            if torch.distributed.is_initialized() else "none"
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.shutdown()


def nccl_rank(rank, port, path, out):
    """A one-rank NCCL group on card 0: one train step of the job (a group
    of one steps as one process does) and an NCCL all-reduce of 1e6 floats,
    timed."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        res = dist_steps(path, 1, dev)
        res["backend"] = torch.distributed.get_backend()
        x = torch.arange(1e6, device=dev)
        y = x.clone()
        torch.distributed.all_reduce(y)
        res["allreduce_ms"] = cuda_ms(lambda: torch.distributed.all_reduce(y))
        res["allreduce_equal"] = bool(torch.equal(x, y))
        torch.save(res, out)
    finally:
        torch.distributed.destroy_process_group()


def dist_agree(tag, got, want, lr, steps):
    """Print and check a run of ranks against the one-process run."""
    first = abs(got["losses"][0] / want["losses"][0] - 1.0)
    scale = {}                   # each layer's largest statistic
    for k, v in want["bn1"].items():
        layer = k.rsplit(".", 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), float(v.abs().max()))
    bn = max((float((got["bn1"][k] - v).abs().max()) /
              max(scale[k.rsplit(".", 1)[0]], 1e-30)
              for k, v in want["bn1"].items()), default=0.0)
    worst, med, ok = params_agree(got["params"], want["params"], lr, steps)
    print(f"[16] {tag}: losses {got['losses']} vs one process "
          f"{want['losses']} (rel {first:.3g} at the first); BatchNorm "
          f"stats after step 1 max|d| {bn:.3g} of their layer's largest "
          f"({len(want['bn1'])} tensors); "
          f"parameters after step {steps} max|d| {worst:.3g} (bound "
          f"{steps * lr / 0.1 ** 0.5:.3g}), largest tensor median |d| "
          f"{med:.3g}", flush=True)
    if first > DIST_LOSS_RTOL or bn > DIST_BN_RTOL or not ok:
        raise AssertionError(f"phase 16 {tag}: ranks and one process "
                             "disagree")


def phase_dist(dev, card, d):
    """Phase 16: two ranks on the card (gloo) against one process, for icon
    and pamir; a one-rank NCCL group; the full-width icon frame sharded
    over two shards of the card against unsharded; exact mode at 257^3;
    the CLIs' too-few-devices errors (or, on >= 2 cards, their runs and the
    ranks over NCCL). Returns (the launches of the main-path runs,
    {kernel: worst error})."""
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.parallel import dist
    from icon_tpu_torch.parallel.mesh import shard_batch
    root = os.path.join(d, "data")
    jobs, lrs = [], []
    t0 = time.perf_counter()
    for prior, steps in (("icon", DIST_STEPS), ("pamir", DIST_PAMIR_STEPS)):
        cfg, batches = dist_batches(root, prior, steps)
        torch.manual_seed(0)
        state = HGPIFuNet(cfg, normal_net=False).state_dict()
        path = os.path.join(d, f"dist_{prior}.pt")
        torch.save({"cfg": cfg, "state": state, "batches": batches}, path)
        jobs.append((path, steps))
        lrs.append(cfg.lr_G)
    print(f"[16] {DIST_STEPS} icon and {DIST_PAMIR_STEPS} pamir global "
          f"batches of {TRAIN_BATCH} ({TRAIN_SIZE}^2, {TRAIN_SAMPLES} "
          f"samples) loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    one = [dist_steps(path, steps, dev) for path, steps in jobs]
    # one process on a rank's slice (batch 2): whether a rank's step time
    # comes from sharing the card or from the batch size alone
    job = torch.load(jobs[0][0], weights_only=False)
    job["batches"] = [shard_batch(b, 0, 2) for b in job["batches"]]
    half_path = os.path.join(d, "dist_half.pt")
    torch.save(job, half_path)
    del job
    half = dist_steps(half_path, DIST_STEPS, dev)
    # both again in a fresh process of their own, with no group: whether a
    # step's time follows the batch, the group or the process's history
    out = os.path.join(d, "fresh_out")
    dist.run_ranks(dist_rank, 1, (dist.free_port(), None, [dev],
                                  [(half_path, DIST_STEPS), jobs[0]], out),
                   timeout=300)
    fresh = torch.load(f"{out}.0", weights_only=False)
    out = os.path.join(d, "dist_out")
    t0 = time.perf_counter()
    dist.run_ranks(dist_rank, 2, (dist.free_port(), "gloo", [dev, dev], jobs,
                                  out), timeout=400)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in (0, 1)]
    runs, worst = [], dict.fromkeys(("knn_f32", *VOXEL_REPLACES), 0.0)
    for j, (prior, steps) in enumerate((("icon", DIST_STEPS),
                                        ("pamir", DIST_PAMIR_STEPS))):
        for r in ranks:
            dist_agree(f"{prior}, rank {r[j]['rank']} of 2 (gloo on one "
                       "card)", r[j], one[j], lrs[j], steps)
            runs.append(r[j]["launched"])
            worst["knn_f32"] = max(worst["knn_f32"], r[j]["knn_err"])
            for name, err in r[j]["voxel_err"].items():
                worst[name] = max(worst[name], err)
        for k, v in ranks[0][j]["params"].items():
            if not torch.equal(v, ranks[1][j]["params"][k]):
                raise AssertionError(f"phase 16 {prior}: the ranks' {k} "
                                     "differ")
    icon, pamir = (ranks[0][0], ranks[1][0]), (ranks[0][1], ranks[1][1])
    check_launched(icon[0]["launched"], ("knn_f32",), "phase 16 rank step")
    check_launched(pamir[0]["launched"], ("voxel_splat", "box_smooth3d"),
                   "phase 16 pamir rank step")
    print(f"[16] icon on {card}, TF32 off: s/step 2 ranks "
          f"{[round(x, 4) for x in icon[0]['step_s']]} (backend "
          f"{icon[0]['backend']}), 1 process "
          f"{[round(x, 4) for x in one[0]['step_s']]}, 1 process on a "
          f"rank's batch of 2 {[round(x, 4) for x in half['step_s']]}, a "
          f"fresh process on 2 / 4 items "
          f"{[round(x, 4) for x in fresh[0]['step_s']]} / "
          f"{[round(x, 4) for x in fresh[1]['step_s']]}; gradient all-reduce "
          f"{icon[0]['reduce_ms']:.2f} ms for {icon[0]['bytes']} bytes; kNN "
          f"launches a rank step {icon[0]['launched']['knn_f32'] / DIST_STEPS}"
          f" ({icon[0]['knn_calls']} calls, first and last vs plain max|dkey|"
          f" {max(r['knn_err'] for r in icon):.3g}); peak GiB rank 0 "
          f"{icon[0]['peak_gib']:.2f}, rank 1 {icon[1]['peak_gib']:.2f}, 1 "
          f"process {one[0]['peak_gib']:.2f}; ranks spawned, run and joined "
          f"in {ranks_s:.2f} s", flush=True)
    print(f"[16] pamir: s/step 2 ranks "
          f"{[round(x, 4) for x in pamir[0]['step_s']]}, 1 process "
          f"{[round(x, 4) for x in one[1]['step_s']]}; "
          f"all-reduce {pamir[0]['reduce_ms']:.2f} ms for "
          f"{pamir[0]['bytes']} bytes; voxelize launches a rank step "
          f"{pamir[0]['launched']['voxel_splat']} (first and last of each "
          f"rank vs plain max|d|: splat {worst['voxel_splat']:.3g}, smooth "
          f"{worst['box_smooth3d']:.3g}); peak GiB "
          f"{pamir[0]['peak_gib']:.2f} / {pamir[1]['peak_gib']:.2f}",
          flush=True)

    out = os.path.join(d, "nccl_out")
    dist.run_ranks(nccl_rank, 1, (dist.free_port(), jobs[0][0], out),
                   timeout=200)
    nccl = torch.load(out, weights_only=False)
    print(f"[16] one-rank NCCL group (backend {nccl['backend']}): NCCL "
          f"all-reduce of 1e6 floats {nccl['allreduce_ms']:.3f} ms, "
          f"unchanged {nccl['allreduce_equal']}", flush=True)
    dist_agree("one-rank NCCL group", nccl,
               dist_steps(jobs[0][0], 1, dev), lrs[0], 1)
    if nccl["backend"] != "nccl" or not nccl["allreduce_equal"]:
        raise AssertionError("phase 16: the NCCL group")

    launched, errs = shard_and_exact(dev, card)
    runs.append(launched)
    worst["knn_f32"] = max(worst["knn_f32"], errs)
    cli_devices(dev, card, d, root, jobs)
    return runs, worst


def shard_and_exact(dev, card, iters: int = 5, size: int = 512,
                    res: int = 256, subdiv: int = 5,
                    exact_res=EXACT_RES):
    """[16d] phase 4's full-width frame with its queries sharded over two
    shards of the card (``pad_multiple`` 2) against unsharded, and [16e]
    exact mode at 257^3 on ``clothed_human_occ`` and on the frame's query
    beside faster mode. Returns (the sharded recon's launches, the kNN's
    worst error against plain on its first and last call)."""
    from icon_tpu_torch.kernels import knn
    from icon_tpu_torch.parallel.mesh import shard_query
    from icon_tpu_torch.recon.engine import ReconEngine
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import (clothed_human_occ,
                                                synthetic_icon_batch)
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=size, n_samples=64,
                                 subdiv=subdiv)
    state = seeded_state(cfg, 0)
    mesh = [dev, dev]
    fr = build_frame(cfg, state, batch, res, dev)
    frs = build_frame(cfg, state, batch, res, dev, mesh=mesh)
    with torch.no_grad():
        cz, _ = fr.columns()
        feats = fr.features()
        occ_u, st_u = fr.engine(fr.query_fn, query_args=(cz, feats))
        calls = []
        remove = knn_spy(calls)
        sync(dev)
        reset_launches()           # count only the main path's launches
        try:
            occ_s, st_s = frs.engine(shard_query(frs.query_fn, mesh),
                                     query_args=(cz, feats))
            sync(dev)
        finally:
            remove()
        launched = read_launches()
    check_launched(launched, ("knn_f32",), "phase 16 sharded recon")
    occ_err = float((occ_u - occ_s).abs().max())
    counts_u = {k: int(v) for k, v in st_u.items() if k != "coarse_occ"}
    counts_s = {k: int(v) for k, v in st_s.items() if k != "coarse_occ"}
    knn_err = 0.0
    for pts, verts, k in (calls[0], calls[-1]):
        idx, key = knn.nearest_vertices_kernel(pts, verts, k)
        sync(dev)
        rel, same, _, _, key0 = knn_picks_agree(idx, key, pts, verts, k)
        if rel > KEY_RTOL or not same:
            raise AssertionError("phase 16: the kNN kernel disagrees with "
                                 "plain on a shard's call")
        knn_err = max(knn_err, float((key - key0).abs().max()))
    times = {"unsharded": [], "sharded": []}
    tris = {}
    for _ in range(3):
        fr.frame()
        frs.frame()
    for _ in range(iters):
        for name, f in (("unsharded", fr), ("sharded", frs)):
            t0 = time.perf_counter()
            _, _, _, faces = f.frame()
            sync(dev)
            times[name].append(time.perf_counter() - t0)
            tris[name] = len(faces)
    print(f"[16] full-width frame sharded over 2 shards of the card "
          f"(pad_multiple {frs.engine.pad_multiple}): level counts "
          f"{counts_s} vs unsharded {counts_u}; occupancy max|d| "
          f"{occ_err:.3g}; triangles {tris['sharded']} vs "
          f"{tris['unsharded']}; kNN launches {launched['knn_f32']} "
          f"({len(calls)} calls: {sorted({len(c[0]) for c in calls})} "
          f"points), first and last vs plain max|dkey| {knn_err:.3g}",
          flush=True)
    print(f"[16] recon latency on {card}, TF32 off (median of {iters}, s): "
          f"sharded {statistics.median(times['sharded']):.4f} "
          f"{[round(x, 4) for x in times['sharded']]}, unsharded "
          f"{statistics.median(times['unsharded']):.4f} "
          f"{[round(x, 4) for x in times['unsharded']]}", flush=True)
    if counts_s != counts_u or tris["sharded"] != tris["unsharded"] or \
            not occ_err <= SHARD_OCC_ATOL:
        raise AssertionError("phase 16: the sharded frame differs")

    with torch.no_grad():
        occ, st = ReconEngine(exact_res, exact=True, conflict_rounds=2,
                              device=dev)(
            lambda p: clothed_human_occ(p)[..., None])
    counts = {k: int(v) for k, v in st.items()}
    print(f"[16] exact mode on clothed_human_occ at {exact_res[-1]}^3: "
          f"{counts}", flush=True)
    if any(counts[f"level{lv}_{s}"] for lv in range(1, len(exact_res))
           for s in ("overflow", "residual")) or \
            not bool(torch.isfinite(occ).all()):
        raise AssertionError("phase 16: exact mode left overflow or "
                             "residual conflicts")
    for mode, eng in (("faster", ReconEngine(exact_res, device=dev)),
                      ("exact", ReconEngine(exact_res, exact=True,
                                            device=dev))):
        secs = []
        with torch.no_grad():
            for i in range(4):
                sync(dev)
                t0 = time.perf_counter()
                occ, st = eng(fr.query_fn, query_args=(cz, feats))
                sync(dev)
                if i:
                    secs.append(time.perf_counter() - t0)
        print(f"[16] {mode} mode on the frame's query at "
              f"{exact_res[-1]}^3: engine {statistics.median(secs):.4f} s "
              f"(median of {len(secs)}) on {card}, TF32 off; "
              f"{ {k: int(v) for k, v in st.items() if k != 'coarse_occ'} }",
              flush=True)
        if not bool(torch.isfinite(occ).all()):
            raise AssertionError(f"phase 16: {mode} mode's grid")
    return launched, knn_err


def cli_devices(dev, card, d, root, jobs):
    """[16f] ``apps.train`` with ``num_devices 2`` and ``apps.infer
    -num_devices 2``: on one card both raise the JAX package's
    too-few-devices error; on two or more they run, and the ranks of
    [16a] run again over NCCL, one a card."""
    from icon_tpu_torch.apps import infer, train
    from icon_tpu_torch.config import save_config
    from icon_tpu_torch.data.fixture import train_config
    from icon_tpu_torch.parallel import dist
    from icon_tpu_torch.recon.frame import bench_config
    cfg_path = write_train_config(train_config(
        root, os.path.join(d, "dist_ckpt"), num_epoch=1), d)
    icfg = os.path.join(d, "bench.yaml")
    save_config(bench_config(), icfg)
    n = torch.cuda.device_count()
    train_argv = ["-cfg", cfg_path, "--max_steps", "2", "num_devices", "2"]
    infer_argv = ["-cfg", icfg, "-in_dir", d, "-out_dir",
                  os.path.join(d, "dist_infer"), "-num_devices", "2"]
    if n < 2:
        for name, run in (("train", lambda: train.main(train_argv)),
                          ("infer", lambda: infer.main(infer_argv))):
            try:
                run()
            except SystemExit as e:
                msg = str(e)
            else:
                raise AssertionError(f"phase 16: {name} with 2 devices on "
                                     "one card did not raise")
            print(f"[16] {name} with 2 devices on {n} card: raises "
                  f"SystemExit({msg!r})", flush=True)
            if msg != f"-num_devices 2 but only {n} devices visible":
                raise AssertionError(f"phase 16: {name}'s error {msg!r}")
        return
    rec = train.main(train_argv)
    print(f"[16] train CLI with 2 ranks on {n} cards: {rec['steps']} steps, "
          f"losses {rec['losses']}, s/step {rec['step_s']}", flush=True)
    if rec["ranks"] != 2 or not np.isfinite(rec["losses"]).all():
        raise AssertionError("phase 16: the 2-card train CLI")
    from icon_tpu_torch.utils.synthetic import write_demo_inputs
    paths = write_demo_inputs(os.path.join(d, "dist_demo"), bench_config())
    recs = infer.main(["-cfg", paths["cfg"], "-in_dir", paths["in_dir"],
                       "-out_dir", paths["out_dir"], "-ckpt", paths["ckpt"],
                       "-normal_ckpt", paths["normal_ckpt"], "-loop_smpl",
                       "10", "-loop_cloth", "0", "-no_remesh",
                       "-allow_random_hps", "-img_size", str(FIT_SIZE),
                       "-mcube_res", str(FIT_RES), "-num_devices", "2"])
    print(f"[16] infer CLI with -num_devices 2: "
          f"{[r['recon'] for r in recs]}", flush=True)
    out = os.path.join(d, "dist_nccl_out")
    dist.run_ranks(dist_rank, 2, (dist.free_port(), None,
                                  [torch.device("cuda", r) for r in (0, 1)],
                                  jobs[:1], out), timeout=300)
    for r in (0, 1):
        res = torch.load(f"{out}.{r}", weights_only=False)[0]
        print(f"[16] icon rank {r} over {res['backend']}: losses "
              f"{res['losses']}, s/step {res['step_s']}, all-reduce "
              f"{res['reduce_ms']:.2f} ms", flush=True)


# phase 17: the winding-cluster sign, the one-shot indexed export and the
# virtual final level
WIND_ATOL = 1e-5        # kernel vs plain (tests/test_torch_winding_cuda.py)
WIND_SIGN_MARGIN = 1e-4
WIND_SAMPLES = 4096     # near-surface samples of the posed body
# float32 operations of the winding kernel a (point, cluster) pair (the
# dipole: a difference, a squared distance, a square root, a dot product,
# a quotient, the gap and the sum: 20) and a (point, face) pair of the
# exact set (three differences of corners, three lengths, the triple
# product, the denominator, an atan2 counted as one, the sum: 67)
WIND_OPS_PER_CLUSTER = 20
WIND_OPS_PER_FACE = 67
MARCH_ATOL = 1e-6       # grid units, the marching kernels against plain
# the lattice wire's u8 fraction along an edge, in normalized units at 257^3
U8_STEP = 3 ** 0.5 / 255 / 128
MARCH_REPLACES = {"mt_emit": "icon_tpu/recon/marching.py:282",
                  "mt_index": "icon_tpu/recon/marching.py:356"}
VIRTUAL_RES = 512       # the memory check's final level: 513^3


def posed_samples(subdiv: int = 4, pose_scale: float = 0.1, seed: int = 5):
    """JAX's tests/test_sdf_fast.py:_posed_body on the port's synthetic
    SMPL-X and WIND_SAMPLES near-surface samples of it: (verts, faces,
    points)."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    model = synthetic_smplx_model(subdiv=subdiv)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        v, _ = model(betas=torch.from_numpy(
            rng.randn(1, 10).astype(np.float32) * 0.3),
            body_pose=torch.from_numpy(
                rng.randn(1, 63).astype(np.float32) * pose_scale))
    v = v[0].numpy()
    pts = v[rng.randint(0, len(v), WIND_SAMPLES)] + \
        rng.normal(scale=0.05, size=(WIND_SAMPLES, 3)).astype(np.float32)
    return v, np.asarray(model.faces, np.int64), pts.astype(np.float32)


def winding_case(dev, name, pts, verts, faces):
    """The kernel against plain at one input: (max |dw|, kernel w, plain w,
    the cluster tables, m)."""
    from icon_tpu_torch.kernels import winding as kw
    from icon_tpu_torch.ops.sdf_fast import build_winding_clusters
    cf, cm = build_winding_clusters(verts, faces)
    table, ctri, mask = kw.cluster_table(
        torch.as_tensor(verts, device=dev),
        torch.as_tensor(faces, dtype=torch.int64, device=dev),
        torch.as_tensor(cf, device=dev), torch.as_tensor(cm, device=dev))
    ctri = ctri.contiguous()
    m = min(16, mask.shape[0])
    p = torch.as_tensor(pts, device=dev).contiguous()
    got = kw.fast_winding_kernel(p, table, ctri, mask, m)
    want = kw.fast_winding_plain(p, table, ctri, mask, m)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    clear = (want - 0.5).abs() > WIND_SIGN_MARGIN
    same = bool(((got > 0.5) == (want > 0.5))[clear].all())
    print(f"[17a] fast_winding {name} N={len(pts)} K={mask.shape[0]} "
          f"M={mask.shape[1]} m={m}: max|dw| {err:.3g}, signs identical "
          f"where |w-0.5|>{WIND_SIGN_MARGIN:g}: {same} ({float(clear.float().mean()):.2%} "
          f"of points), inside {float((want > 0.5).float().mean()):.2%}",
          flush=True)
    if err > WIND_ATOL or not same:
        raise AssertionError(f"fast_winding disagrees with plain: {name}")
    return err, got, want, (p, table, ctri, mask, m)


def winding_bound(n: int, K: int, m: int, faces_each: float, M: int):
    """(least time in ms, by) of the winding kernel on n points: its
    operations over the float32 peak and its bytes (points in, winding out,
    the cluster table and triangles once) over the memory rate."""
    ops = n * (K * WIND_OPS_PER_CLUSTER + m * faces_each * WIND_OPS_PER_FACE)
    return bound(16.0 * n + 32.0 * K + 37.0 * K * M, ops)


def phase_winding_kernel(dev, verts_np, faces_np):
    """[17a] fast_winding against plain at the main path's shapes (the
    level-0 lattice, the engine's 232,974 cap around the subdiv-5 body)
    and on near-surface samples of a posed body, whose kernel signs must
    equal the dense exact winding's; each timed alone beside its bound.
    Returns the summary entry."""
    from icon_tpu_torch.kernels import winding as kw
    from icon_tpu_torch.ops.sdf import point_mesh_dist_winding
    rng = np.random.RandomState(7)
    v = len(verts_np)
    d = rng.normal(size=(KNN_CAP, 3))
    d *= (0.02 * rng.uniform(0, 1, (KNN_CAP, 1)) ** (1 / 3)
          / np.linalg.norm(d, axis=1, keepdims=True))
    cap = (verts_np[rng.randint(0, v, KNN_CAP)] + d).astype(np.float32)
    lattice = level0_points(33, dev)[0].cpu().numpy()
    worst, timing = 0.0, {}
    for name, pts in (("level 0 lattice", lattice), ("cap near", cap)):
        err, got, want, args = winding_case(dev, name, pts, verts_np,
                                            faces_np)
        worst = max(worst, err)
        p, table, ctri, mask, m = args
        tiles = kw.face_tiles(ctri, mask)
        out = torch.empty_like(got)
        K, M = mask.shape
        ms = kernel_ms(lambda: kw._launch(p, table, tiles, M, m, out))
        plain_ms = cuda_ms(lambda: kw.fast_winding_plain(p, table, ctri,
                                                         mask, m), reps=3)
        # the wrapper adds face_tiles' copy of the triangles to the launch
        wrapper_ms = cuda_ms(lambda: kw.fast_winding_kernel(p, table, ctri,
                                                            mask, m))
        b_ms, b_by = winding_bound(len(pts), K, m, float(mask.sum()) / K, M)
        info = kw.kernel_info(K)
        print(f"[17a] fast_winding {name}: kernel alone {ms:.4f} ms, "
              f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it; instance for "
              f"K={K}: {info}", flush=True)
        timing[name] = (ms, plain_ms, b_ms, b_by)
    pv, pf, pts = posed_samples()
    err, got, _, _ = winding_case(dev, "posed body samples", pts, pv, pf)
    worst = max(worst, err)
    _, _, w = point_mesh_dist_winding(torch.as_tensor(pts, device=dev),
                                      torch.as_tensor(pv[pf], device=dev))
    n_diff = int(((got > 0.5) != (w > 0.5)).sum())
    print(f"[17a] posed body: kernel signs vs the dense exact winding: "
          f"{n_diff} of {len(pts)} differ", flush=True)
    if n_diff:
        raise AssertionError("fast_winding signs differ from the exact "
                             "winding on the posed body")
    ms, plain_ms, b_ms, b_by = timing["cap near"]
    return {"name": "fast_winding", "route": "cuda",
            "source": "icon_tpu_torch/csrc/winding.cu",
            "replaces": "icon_tpu/ops/sdf_fast.py:183",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def pseudo_normal_small(dev):
    """[17b] the pseudo-normal sign (no sign input) on the card against
    the CPU at small size: signs identical wherever |sdf| > 1e-3."""
    from icon_tpu_torch.ops.sdf_fast import (build_vertex_face_table,
                                             point_body_features)
    from icon_tpu_torch.utils.synthetic import synthetic_body
    v, f = synthetic_body(subdiv=3)
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.7, 0.7, (4096, 3)).astype(np.float32)
    table = build_vertex_face_table(f, len(v))
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        args = [torch.as_tensor(x, device=d) for x in
                (pts, v, f.astype(np.int64), table.astype(np.int64))]
        sdf, _, _, _ = point_body_features(
            *args, torch.zeros(len(v), 3, device=d),
            torch.zeros(len(v), 1, device=d))
        out[name] = sdf[:, 0].cpu()
    clear = out["cpu"].abs() > 1e-3
    same = bool(((out["gpu"] > 0) == (out["cpu"] > 0))[clear].all())
    print(f"[17b] pseudo-normal sign, card vs CPU on 4096 points: signs "
          f"identical where |sdf|>1e-3: {same}, max|dsdf| "
          f"{float((out['gpu'] - out['cpu']).abs().max()):.3g}", flush=True)
    if not same:
        raise AssertionError("pseudo-normal sign: card disagrees with CPU")


def stage_times(fr, iters: int):
    """(frame latencies, engine-stage seconds) of ``iters`` frames after 2
    warm-up frames."""
    for _ in range(2):
        fr.frame()
    lat, eng = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.frame()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        with torch.no_grad():
            cz, _ = fr.columns()
            feats = fr.features()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fr.engine(fr.query_fn, query_args=(cz, feats))
            torch.cuda.synchronize()
        eng.append(time.perf_counter() - t0)
    return lat, eng


def phase_winding_frame(dev, card, iters: int = 3):
    """[17b] phase 4's full-width frame with the winding-cluster sign
    through ``HGPIFuNet.query``: level counts and triangles against the
    JAX package's, latency and the engine stage beside the crossing-column
    frame's; fast_winding launched. Returns (its launches, the frame's
    final grid and coarse grid for [17c])."""
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=512, n_samples=64, subdiv=5)
    state = seeded_state(cfg, 0)
    frames = {s: build_frame(cfg, state, batch, 256, dev, sign=s)
              for s in ("columns", "winding")}
    lat_c, eng_c = stage_times(frames["columns"], iters)
    reset_launches()                  # count only the main path's launches
    stats, _, verts, faces = frames["winding"].frame()
    torch.cuda.synchronize()
    launched = read_launches()
    lat_w, eng_w = stage_times(frames["winding"], iters)
    l1, l2 = int(stats["level1_points"]), int(stats["level2_points"])
    ov = [int(stats[k]) for k in sorted(stats) if k.endswith("_overflow")]
    print(f"[17b] winding-sign frame: level1 {l1} (JAX {JAX_LEVEL1_POINTS})"
          f", level2 {l2} (JAX {JAX_LEVEL2_POINTS}), n_tris {len(faces)} "
          f"(JAX {JAX_N_TRIS}), overflow {ov}, launches {launched}",
          flush=True)
    print(f"[17b] latency per frame (s): winding median "
          f"{statistics.median(lat_w):.4f} all {[round(x, 4) for x in lat_w]}"
          f", columns median {statistics.median(lat_c):.4f} all "
          f"{[round(x, 4) for x in lat_c]}; engine stage (s): winding "
          f"{statistics.median(eng_w):.4f}, columns "
          f"{statistics.median(eng_c):.4f} on {card}, TF32 off", flush=True)
    if len(faces) == 0 or not np.isfinite(verts).all() or any(ov):
        raise AssertionError("winding-sign frame: empty mesh or overflow")
    check_launched(launched, ("fast_winding", "knn_f32"),
                   "the winding-sign frame")
    for name, got, ref in (("level1_points", l1, JAX_LEVEL1_POINTS),
                           ("level2_points", l2, JAX_LEVEL2_POINTS),
                           ("n_tris", len(faces), JAX_N_TRIS)):
        if abs(got - ref) > COUNT_RTOL * ref:
            raise AssertionError(f"winding frame {name} {got} vs JAX {ref}")
    fc = frames["columns"]
    with torch.no_grad():
        cz, _ = fc.columns()
        occ, st = fc.engine(fc.query_fn, query_args=(cz, fc.features()))
    return launched, occ, st["coarse_occ"]


def sorted_faces(f: np.ndarray) -> np.ndarray:
    return f[np.lexsort(f.T[::-1])]


def phase_indexed_export(dev, occ):
    """[17c] the frame's 257^3 grid through ``extract_mesh`` without a
    marcher (mt_emit, then mt_index): the triangle count, the lattice
    marcher's vertex count and face set, vertices within the u8 step of
    its; faces identical to the plain version's and vertices within
    MARCH_ATOL grid units; both pack wires round-trip; each kernel alone
    beside its bound. Returns (launches, summary entries)."""
    from icon_tpu_torch.kernels import marching as km
    from icon_tpu_torch.recon import marching as PM
    from icon_tpu_torch.recon.export import extract_mesh, make_marcher
    reset_launches()                  # count only the main path's launches
    v, f = extract_mesh(occ)
    torch.cuda.synchronize()
    launched = read_launches()
    check_launched(launched, ("mt_emit", "mt_index"), "the one-shot export")
    lv, lf = extract_mesh(occ, marcher=make_marcher())
    vd = float(np.abs(v - lv).max()) if len(v) == len(lv) else float("inf")
    same_set = len(f) == len(lf) and np.array_equal(sorted_faces(f),
                                                    sorted_faces(lf))
    print(f"[17c] one-shot indexed export at 257^3: n_tris {len(f)} (JAX "
          f"{JAX_N_TRIS}), n_verts {len(v)}; lattice marcher {len(lf)} / "
          f"{len(lv)}: face set equal {same_set}, faces identical "
          f"{np.array_equal(f, lf)}, max|dv| {vd:.3g} (u8 step "
          f"{U8_STEP:.3g}), launches {launched}", flush=True)
    if len(f) != len(lf) or len(v) != len(lv) or not same_set or \
            vd > U8_STEP or abs(len(f) - JAX_N_TRIS) > COUNT_RTOL * JAX_N_TRIS:
        raise AssertionError("the one-shot export disagrees with the "
                             "lattice marcher")
    fine = occ[1:, 1:, 1:].contiguous()
    kw = dict(max_cells=1 << 18, max_tris=1 << 20, max_verts=1 << 21)
    out = PM.marching_tetrahedra_indexed(fine, **kw)
    cx, cy, cz, _, _, n_cells, _ = PM._active_cells(fine, 0.5, 1 << 18,
                                                    None)
    plain_e = km.mt_emit_plain(fine, cx, cy, cz, n_cells, 0.5, 1 << 20)
    plain_i = km.mt_index_plain(*plain_e[:5], 1 << 21, tuple(fine.shape))
    nv, nt = int(out.n_verts), int(out.n_tris)
    f_same = torch.equal(out.faces, plain_i[3]) and \
        int(plain_i[4]) == nv and int(plain_e[4]) == nt
    verr = max(float((a[:nv] - b[:nv]).abs().max()) for a, b in
               zip((out.verts_x, out.verts_y, out.verts_z), plain_i[:3]))
    slots = 3 * nt
    e_err = max(float((a.reshape(-1)[:slots] - b.reshape(-1)[:slots])
                      .abs().max()) for a, b in
                (zip(plain_e[:3], km.mt_emit(fine, cx, cy, cz, n_cells, 0.5,
                                             1 << 20)[:3])))
    print(f"[17c] kernels vs plain on the card: faces identical {f_same}, "
          f"max|dv| {verr:.3g} grid units, mt_emit's vertex slots max|d| "
          f"{e_err:.3g}", flush=True)
    if not f_same or verr > MARCH_ATOL or e_err > MARCH_ATOL:
        raise AssertionError("marching kernels disagree with plain")
    for quantize in (False, True):
        pv, pf = PM.unpack_mesh(PM.pack_mesh(out, quantize=quantize),
                                quantize=quantize)
        d = float(np.abs(pv - torch.stack([out.verts_x, out.verts_y,
                                           out.verts_z], -1)[:nv]
                         .cpu().numpy()).max())
        ok = len(pv) == nv and len(pf) == nt and d <= (0.5 / 64 + 1e-6
                                                       if quantize else 0.0)
        print(f"[17c] pack/unpack quantize={quantize}: {len(pv)} verts, "
              f"{len(pf)} faces, max|dv| {d:.3g}", flush=True)
        if not ok:
            raise AssertionError(f"pack_mesh round trip (quantize="
                                 f"{quantize})")
    # each kernel alone on preallocated buffers
    nc = cx.shape[0]
    eb = km.emit_buffers(nc, 1 << 20, dev)
    e_ms = kernel_ms(lambda: km._emit_launch(fine, cx, cy, cz, n_cells, 0.5,
                                             1 << 20, *eb))
    tv, teid, n_tris = eb[2], eb[3], torch.clamp(eb[4], max=1 << 20)
    ib = km.index_buffers(1 << 20, 1 << 21, tuple(fine.shape), dev)
    i_ms = kernel_ms(lambda: km._index_launch(tv[0], tv[1], tv[2], teid,
                                              n_tris, 1 << 21, *ib))
    e_plain = cuda_ms(lambda: km.mt_emit_plain(fine, cx, cy, cz, n_cells,
                                               0.5, 1 << 20), reps=3)
    i_plain = cuda_ms(lambda: km.mt_index_plain(*plain_e[:5], 1 << 21,
                                                tuple(fine.shape)), reps=3)
    lib_ms = cuda_ms(lambda: torch.unique(teid[:nt], sorted=True,
                                          return_inverse=True), reps=3)
    n_act = int(n_cells)
    e_b = bound(n_act * (24.0 + 32.0) + nt * 3 * 20.0, 0.0)
    i_b = bound(nt * 3 * 20.0 + nt * 3 * 4.0 + nv * 12.0, 0.0)
    print(f"[17c] mt_emit alone {e_ms:.4f} ms (plain {e_plain:.4f}, bound "
          f"{e_b[0]:.4f} {e_b[1]}, {e_b[0] / e_ms:.1%}); mt_index alone "
          f"{i_ms:.4f} ms (plain {i_plain:.4f}, bound {i_b[0]:.4f} "
          f"{i_b[1]}, {i_b[0] / i_ms:.1%}; torch.unique with inverse "
          f"{lib_ms:.4f} ms); {n_act} cells, {nt} triangles, {nv} vertices",
          flush=True)
    entries = []
    for name, ms, plain_ms, b, lib in (("mt_emit", e_ms, e_plain, e_b, None),
                                       ("mt_index", i_ms, i_plain, i_b,
                                        lib_ms)):
        entries.append({"name": name, "route": "cuda",
                        "source": "icon_tpu_torch/csrc/marching.cu",
                        "replaces": MARCH_REPLACES[name],
                        "max_abs_err": max(verr, e_err), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b[0],
                        "bound_by": b[1], "library_ms": lib})
    return launched, entries


def largest_allocation(fn):
    """(fn's result, the largest single device allocation it made, its
    peak allocated bytes above the start) from the caching allocator's
    trace."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dev = torch.cuda.current_device()
    torch.cuda.memory._record_memory_history(enabled="all", context=None,
                                             max_entries=200000)
    try:
        n0 = len(torch.cuda.memory._snapshot()["device_traces"][dev])
        out = fn()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][dev][n0:]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    sizes = [e["size"] for e in trace if e["action"] == "alloc"]
    return out, max(sizes), torch.cuda.max_memory_allocated() - base


def phase_virtual(dev):
    """[17d] ReconEngine(virtual_final=True) with AutoMarcher(virtual=True)
    at res 256 on ``clothed_human_occ`` against the materialized final
    level: the same face set, vertices within the u8 step; at 513^3 both
    ways' peak memory, and the virtual way allocates no fine grid."""
    from icon_tpu_torch.recon.engine import (ReconEngine,
                                             reconstruction_resolutions)
    from icon_tpu_torch.recon.marching import AutoMarcher
    from icon_tpu_torch.utils.synthetic import clothed_human_occ

    def field(p):
        return clothed_human_occ(p)[..., None]

    def caps(res):
        # the frame's marcher sizes (recon/frame.py:_marcher), twice the
        # cells: the mixed coarse cells of 257^3 fill its candidate buffer
        s = max((res // 256) ** 2, 1)
        return dict(max_cells=(1 << 19) * s, max_tris=(1 << 19) * s,
                    max_verts=(1 << 19) * s, codec="lattice")

    class Way:
        """One way of the final level at ``res``: an engine and a marcher
        held across frames, so that later frames march with autotuned
        buffers."""

        def __init__(self, res, virtual):
            self.virtual = virtual
            self.engine = ReconEngine(reconstruction_resolutions(res),
                                      virtual_final=virtual, device=dev)
            self.marcher = AutoMarcher(virtual=virtual,
                                       slice_one=not virtual, **caps(res))

        def frame(self):
            occ, st = self.engine(field)
            out = self.marcher(occ) if self.virtual else \
                self.marcher(occ, coarse_occ=st["coarse_occ"])
            return self.marcher.unpack(self.marcher.pack(out)), out, st

    (vv, fv), _, st = Way(256, True).frame()
    (vm, fm), _, _ = Way(256, False).frame()
    d = float(np.abs(vv - vm).max()) / 128 if len(vv) == len(vm) else \
        float("inf")
    same = len(fv) == len(fm) and np.array_equal(sorted_faces(fv),
                                                 sorted_faces(fm))
    print(f"[17d] virtual final level at 257^3: {len(fv)} faces, {len(vv)} "
          f"verts (materialized {len(fm)} / {len(vm)}), face set equal "
          f"{same}, max|dv| {d:.3g} normalized (u8 step {U8_STEP:.3g}), "
          f"final_res {st['final_res']}", flush=True)
    if not same or d > U8_STEP or st["final_res"] != 257 or len(fv) < 1000:
        raise AssertionError("virtual final level disagrees with the "
                             "materialized one")
    fine_bytes = 4 * VIRTUAL_RES ** 3
    res = {}
    for name, virtual in (("virtual", True), ("materialized", False)):
        way = Way(VIRTUAL_RES, virtual)
        way.frame()                   # the first frame sizes the buffers
        ((_, faces), out, _), big, peak = largest_allocation(way.frame)
        over = int(out.n_cells_total) > int(out.n_cells)
        res[name] = (big, peak, len(faces), over)
        print(f"[17d] {name} at {VIRTUAL_RES + 1}^3, second frame: "
              f"{len(faces)} faces, peak {peak / 2 ** 30:.3f} GiB above "
              f"the start, largest allocation {big / 2 ** 20:.1f} MiB (a "
              f"fine grid {fine_bytes / 2 ** 20:.1f} MiB), cell overflow "
              f"{over}", flush=True)
        del way
    if res["virtual"][0] >= fine_bytes or res["materialized"][0] < \
            fine_bytes or res["virtual"][2] != res["materialized"][2] or \
            res["virtual"][3] or res["materialized"][3]:
        raise AssertionError("virtual final level at 513^3: a fine grid "
                             "was allocated, or the meshes differ")


def phase_signs_meshing(dev, card, verts_np, faces_np):
    """Phase 17: returns (summary entries, main-path launch counts)."""
    entries = [phase_winding_kernel(dev, verts_np, faces_np)]
    pseudo_normal_small(dev)
    launched_w, occ, _ = phase_winding_frame(dev, card)
    launched_e, march_entries = phase_indexed_export(dev, occ)
    entries += march_entries
    del occ
    phase_virtual(dev)
    return entries, [launched_w, launched_e]


def descendants(pid: int) -> list:
    """The live descendants of ``pid`` from /proc (each /proc/<pid>/stat's
    parent id, followed down from ``pid``), zombies left out."""
    children, state = {}, {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        state[int(name)] = fields[0]
        children.setdefault(int(fields[1]), []).append(int(name))
    out, todo = [], list(children.get(pid, []))
    while todo:
        p = todo.pop()
        todo += children.get(p, [])
        if state.get(p) != "Z":
            out.append(p)
    return sorted(out)


def no_process_left(wait_s: float = 5.0) -> bool:
    """Whether this process has no live descendant, allowing them
    ``wait_s`` to exit; prints those that remain with their command
    lines."""
    deadline = time.monotonic() + wait_s
    while True:
        left = descendants(os.getpid())
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    for p in left:
        try:
            with open(f"/proc/{p}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = "?"
        print(f"chip_smoke: process {p} still running: {cmd}",
              file=sys.stderr)
    print(f"[18] descendant processes left: {len(left)}", flush=True)
    return not left


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
    from icon_tpu_torch.kernels import knn, marching, raster, voxelize, \
        winding
    knn.launches = 0
    raster.launches_setup = raster.launches_bin = 0
    raster.launches_fwd = raster.launches_bwd = 0
    voxelize.launches_splat = voxelize.launches_smooth = 0
    winding.launches = 0
    marching.launches_emit = marching.launches_index = 0


def read_launches() -> dict:
    from icon_tpu_torch.kernels import knn, marching, raster, voxelize, \
        winding
    return {"knn_f32": knn.launches, "raster_setup": raster.launches_setup,
            "raster_bin": raster.launches_bin,
            "raster_fwd": raster.launches_fwd,
            "raster_bwd": raster.launches_bwd,
            "voxel_splat": voxelize.launches_splat,
            "box_smooth3d": voxelize.launches_smooth,
            "fast_winding": winding.launches,
            "mt_emit": marching.launches_emit,
            "mt_index": marching.launches_index}


def timed(label: str, fn, *args):
    """``fn(*args)``, printing its seconds as phase ``label``'s."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] phase {label}: {time.perf_counter() - t0:.2f} s",
          flush=True)
    return out


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
    timed("4 small", phase_small_frame, dev)
    launched, buckets = timed("4 full", phase_full_frame, dev, card)
    runs = [launched]
    summary = [timed("3", phase_knn, dev, verts_np, buckets)]
    timed("5", phase_raster, dev, verts_np, faces_np)
    timed("6 small", phase_small_normalnet_frame, dev)
    runs.append(timed("6 full", phase_full_normalnet_frame, dev, card))
    summary += timed("7", phase_raster_kernels, dev, verts_np, faces_np)
    timed("8", phase_small_fit_frame, dev)
    launched, fit_errs = timed("9", phase_full_fit_frame, dev, card)
    runs.append(launched)
    launched, cli_errs = timed("10", phase_cli, dev, card)
    runs.append(launched)
    launched, photo_errs = timed("11", phase_photo_path, dev, card)
    runs.append(launched)
    launched, hps_errs = timed("12", phase_other_hps, dev, card)
    runs += launched
    entries, launched, prior_errs = timed("13", phase_priors, dev, card)
    summary += entries
    runs += launched
    with tempfile.TemporaryDirectory() as d:
        launched, train_errs = timed("14", phase_train, dev, card, d)
        runs += launched
        launched, render_errs = timed("15", phase_render_normal, dev, card,
                                      d)
        runs += launched
        launched, dist_errs = timed("16", phase_dist, dev, card, d)
        runs += launched
    entries, launched = timed("17", phase_signs_meshing, dev, card,
                              verts_np, faces_np)
    summary += entries
    runs += launched
    for entry in summary:           # the launches of the main paths' runs
        entry["launches"] = sum(run.get(entry["name"], 0) for run in runs)
        entry["max_abs_err"] = max(
            entry["max_abs_err"], *(errs.get(entry["name"], 0.0) for errs in
                                    (fit_errs, cli_errs, photo_errs,
                                     hps_errs, prior_errs, train_errs,
                                     render_errs, dist_errs)))
        entry["share"] = entry["bound_ms"] / entry["ms"]
    if not no_process_left():
        return 3

    print(json.dumps({"kernels": summary}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
