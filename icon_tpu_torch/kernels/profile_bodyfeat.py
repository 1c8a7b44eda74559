"""The body-feature kernel of two checkouts, parent and change, in one
process on one CUDA card.

Inputs: ``chip_smoke.py`` phase 20's. The subdiv-5 synthetic body (10,242
vertices, 20,480 faces, an 8-slot vertex-face table), signed by the
crossing columns of the frame's 257^2 lattice, at the level-0 lattice
(33^3 points), phase 4's level-1 and level-2 bucket sizes (36,864 and
98,304 points within 2 cm of the body) and the 232,974-point cap, k = 2.
The change is this tree; ``--parent DIR`` names another checkout, whose
``icon_tpu_torch`` is imported as a package copy of its own and builds its
kernels into its own ``_build``. Only the public wrapper
``kernels/bodyfeat.py:body_features_kernel`` is called, so any two
checkouts compare (this tree's builds the face records in the call). At
each shape:

1. before the rounds, each version's outputs held bit for bit to this
   tree's plain twin;
2. for each version in ``--order``: the wrapper's device time a call
   alone (20 calls queued behind a device sleep, CUDA events around them,
   the median of 5; ``profile_lattice.alone_ms``), the same calls' device
   time by kernel from torch.profiler's CUDA table (this tree's record
   build and kernel apart), and the wrapper's host dispatch a call (host
   clock, the median of 5 runs of 20 calls).

``--groups 1,2,4,8,16,32`` times this tree's wrapper instead with the
kernel built at each bound on the lanes a point (``kMaxGroup`` of
``csrc/bodyfeat.cu``, the source's only change; one nvcc each, all
started together), outputs held to the twin, at the same shapes, twice
in turn; the group size that the tree keeps is the fastest there.

Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.kernels.profile_bodyfeat --parent DIR \\
        [--order parent,change,change,parent] [--out FILE]
    python3 -m icon_tpu_torch.kernels.profile_bodyfeat --groups 1,2,4,8,16,32
"""

import argparse
import json
import os.path as osp
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from icon_tpu_torch.kernels.profile_lattice import alone_ms, dispatch_ms
from icon_tpu_torch.kernels.profile_marching import (device_split,
                                                     load_checkout)

CAP = 232974              # the engine's query cap (chip_smoke.py KNN_CAP)
BUCKETS = (36864, 98304)  # phase 4's level-1 and level-2 bucket sizes
SIDE = 257                # the frame's column lattice at res 256


def near_points(verts_np, n, rng):
    """``n`` points within 2 cm of random vertices (phase 20's)."""
    d = rng.normal(size=(n, 3))
    d *= (0.02 * rng.uniform(0, 1, (n, 1)) ** (1 / 3)
          / np.linalg.norm(d, axis=1, keepdims=True))
    return (verts_np[rng.randint(0, len(verts_np), n)] + d).astype(
        np.float32)


def inputs(dev):
    """({shape name: points}, the body's kernel inputs but the points and
    their ids, the sign's keywords)."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    from icon_tpu_torch.ops.sdf_fast import build_crossing_columns_blocked
    from icon_tpu_torch.recon.frame import body_bins
    from icon_tpu_torch.utils.synthetic import synthetic_body
    verts_np, faces_np = synthetic_body(subdiv=5)
    verts = torch.from_numpy(verts_np).to(dev)
    faces = torch.from_numpy(faces_np.astype(np.int64)).to(dev)
    bins = body_bins(verts_np, faces_np, SIDE, dev)
    cross_z, _ = build_crossing_columns_blocked(
        verts, faces, bins.bins, bins.bin_meta, bins.col_x, bins.col_y,
        tile_ids=bins.tile_ids)
    body = (verts, faces, bins.vf_table, vertex_normals(verts[None],
                                                        faces)[0],
            ((verts - verts.amin(0)) /
             (verts.amax(0) - verts.amin(0))).contiguous(),
            (verts[:, 2:3] > 0).float())
    g = torch.linspace(0.0, 1.0, 33, device=dev)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    lattice = torch.stack([xx, yy, zz], -1).reshape(-1, 3) * \
        torch.tensor([2.0, -2.0, 2.0], device=dev) + \
        torch.tensor([-1.0, 1.0, -1.0], device=dev)
    rng = np.random.RandomState(20)
    shapes = {"level 0 lattice": lattice.contiguous()}
    for lv, n in zip((1, 2), BUCKETS):
        shapes[f"level {lv} bucket"] = torch.from_numpy(
            near_points(verts_np, n, rng)).to(dev)
    shapes["cap"] = torch.from_numpy(near_points(verts_np, CAP, rng)).to(dev)
    sign = {"cross_z": cross_z.contiguous(), "cross_meta": bins.cross_meta}
    return shapes, body, sign


def profile_shape(versions, order, pts, body, sign) -> dict:
    from icon_tpu_torch.kernels import bodyfeat as kb
    from icon_tpu_torch.kernels import knn
    nn, _ = knn.nearest_vertices_kernel(pts, body[0], 2)
    args = (pts, nn) + body
    want = kb.point_body_features_plain(*args, **sign)
    calls = {}
    for name, vkb in versions.items():
        got = vkb.body_features_kernel(*args, **sign)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}'s body features disagree with "
                                 f"the plain twin at N={len(pts)}")
        calls[name] = lambda vkb=vkb: vkb.body_features_kernel(*args,
                                                               **sign)
    rounds = []
    for name in order:
        fn = calls[name]
        rounds.append({"version": name, "alone_ms": alone_ms(fn),
                       "device": device_split(fn),
                       "dispatch_ms": dispatch_ms(fn)})
        r = rounds[-1]
        by_kernel = {k: v[0] for k, v in r["device"]["launches"].items()}
        print(f"[N={len(pts)}] {name}: alone {r['alone_ms']:.4f} ms; by "
              f"kernel {by_kernel}; host dispatch {r['dispatch_ms']:.4f} "
              f"ms a call", flush=True)
    return {"points": len(pts), "rounds": rounds}


def group_sweep(groups, shapes, body, sign) -> dict:
    """{group bound: {shape: [ms alone, one a round]}}: this tree's
    wrapper with the kernel built at each bound on the lanes a point."""
    from icon_tpu_torch.kernels import bodyfeat as kb
    from icon_tpu_torch.kernels import build, knn
    with open(osp.join(build._SRC_DIR, "bodyfeat.cu")) as f:
        src = f.read()
    pattern = r"constexpr int kMaxGroup = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise RuntimeError("csrc/bodyfeat.cu: no single kMaxGroup")
    cases = {}
    for name, pts in shapes.items():
        nn, _ = knn.nearest_vertices_kernel(pts, body[0], 2)
        args = (pts, nn) + body
        cases[name] = (args, kb.point_body_features_plain(*args, **sign))
    kept, out = kb._load(), {}
    with tempfile.TemporaryDirectory(dir=build._CACHE_DIR) as d:
        procs = {}
        for g in groups:
            cu = osp.join(d, f"bodyfeat_g{g}.cu")
            with open(cu, "w") as f:
                f.write(re.sub(pattern, f"constexpr int kMaxGroup = {g};",
                               src))
            procs[g] = subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, cu, "-o",
                 cu[:-3] + ".so"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        logs = {g: proc.communicate()[0] for g, proc in procs.items()}
        for g, proc in procs.items():
            if proc.returncode:
                raise RuntimeError(f"nvcc failed at kMaxGroup {g}:\n"
                                   f"{logs[g]}")
        libs = {g: kb._bind(osp.join(d, f"bodyfeat_g{g}.so"))
                for g in groups}
        try:
            for _ in range(2):
                for g, lib in libs.items():
                    kb._lib = lib
                    row = out.setdefault(g, {})
                    for name, (args, want) in cases.items():
                        got = kb.body_features_kernel(*args, **sign)
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b)
                                   for a, b in zip(got, want)):
                            raise AssertionError(
                                f"kMaxGroup {g}: the body features "
                                f"disagree with the plain twin at {name}")
                        row.setdefault(name, []).append(alone_ms(
                            lambda: kb.body_features_kernel(*args, **sign)))
                    print(f"kMaxGroup {g}: " + "; ".join(
                        f"{k} {v[-1]:.4f}" for k, v in row.items()) +
                        " ms alone", flush=True)
        finally:
            kb._lib = kept
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--groups", help="bounds on the lanes a point to time "
                    "this tree's kernel at, e.g. 1,2,4,8,16,32")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bodyfeat: no CUDA card", file=sys.stderr)
        return 2
    order = [] if args.groups else args.order.split(",")
    if "parent" in order and not args.parent:
        ap.error("--parent is needed for the parent's rounds")
    from icon_tpu_torch.kernels import bodyfeat as kb
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    versions = {}
    if "parent" in order:
        versions["parent"], = load_checkout(
            args.parent, ("kernels.bodyfeat",), lambda m: m._load())
    if "change" in order:
        kb._load()
        versions["change"] = kb
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    shapes, body, sign = inputs(dev)
    result = {"card": card, "order": order,
              "kernel_info": kb.kernel_info(2 * body[2].shape[1])}
    print(f"kernels: {result['kernel_info']}", flush=True)
    if args.groups:
        result["groups"] = group_sweep(
            [int(g) for g in args.groups.split(",")], shapes, body, sign)
    for name, pts in shapes.items() if order else ():
        result[name] = profile_shape(versions, order, pts, body, sign)
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
