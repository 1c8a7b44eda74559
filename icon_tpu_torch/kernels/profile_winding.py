"""The fast-winding kernel's face loop in SASS, and the ceilings it gives,
on one CUDA card.

Builds ``csrc/winding.cu`` and reads the instance that K <= 256 clusters
launch (8 keys a lane) from ``cuobjdump -sass`` of the built library. Its
face loop is the innermost loop (a backward branch) holding a face's
FACE_LOADS global loads and a MUFU.RCP; the walk follows its common path:
a predicated forward branch around a short slow path that holds a CALL (a
square root's or a division's special operands) is taken, every other
branch is not, so the slot index's wrap counts once a face. Prints, a
face: the instructions by opcode, their total, the float-pipe ones
(FLOAT_OPS) and atan2f's (the largest BSSY..BSYNC region of the walk that
holds a MUFU.RCP).

Then on chip_smoke.py phase 17a's inputs (the subdiv-5 synthetic body's
clusters, K = 256, M = 80, m = 16; the engine's 33^3 level-0 lattice and
232,974 points within 0.02 of its vertices, seed 7) it times the kernel
alone and through its wrapper (which adds ``face_tiles``' copy), and
prints two ceilings at the float32 instruction issue rate: the kernel's
operations unfused, chip_smoke.py's WIND_OPS_PER_CLUSTER and
WIND_OPS_PER_FACE with atan2f at its SASS count; and every instruction of
the face loop's common path. The bound (atan2 as one operation, at the
float32 peak) is chip_smoke.py's.

    python3 -m icon_tpu_torch.kernels.profile_winding [--out FILE]
"""

import argparse
import json
import os.path as osp
import re
import statistics
import subprocess

import numpy as np
import torch

# chip_smoke.py's operation counts, float32 peak and instruction issue rate
WIND_OPS_PER_CLUSTER = 20
WIND_OPS_PER_FACE = 67
FP32_PEAK = 67e12
FP32_INSTR_RATE = 33.5e12
# float-pipe instructions of the SASS (float32, the special functions and
# the float64 add with its conversion)
FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK",
             "FSET", "MUFU", "DADD", "F2F")
# the global loads of a face: nine corner coordinates and the mask
FACE_LOADS = 10
# a forward branch around at most this many instructions that hold a CALL
# skips a slow path
SLOW_PATH_MAX = 8
LATTICE, CAP = 33, 232974


def sass_functions(sass: str, name: str) -> dict:
    """{function: [(predicated, opcode, operands)]} of every function of a
    ``cuobjdump -sass`` listing whose name holds ``name``; a branch's
    operand is its target's instruction index (None if outside)."""
    funcs, labels, ins, fn = {}, {}, None, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            ins = funcs.setdefault(fn, []) if name in fn else None
            labels[fn] = {}
            continue
        if ins is None:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[fn][lab.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            text = m.group(2).strip()
            pred = text.startswith("@")
            if pred:
                text = text.split(None, 1)[1]
            op, _, args = text.partition(" ")
            ins.append([int(m.group(1), 16), pred, op, args.strip()])
    for fn, ins in funcs.items():
        addr = {a: i for i, (a, *_) in enumerate(ins)}
        for x in ins:
            t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)\s*\)?$", x[3])
            if x[2].startswith("BRA") and t:
                tgt = t.group(1)
                x[3] = labels[fn].get(tgt) if tgt.startswith(".") else \
                    addr.get(int(tgt, 16))
        funcs[fn] = [tuple(x[1:]) for x in ins]
    return funcs


def face_loop(ins: list) -> dict:
    """The face loop of one function's instructions (from
    :func:`sass_functions`), walked along its common path: {"faces a
    trip", "per face": {opcode: instructions}, "total", "float", "atan2f"}
    a face; {} where no such loop is found."""
    loops = []
    for i, (_, op, tgt) in enumerate(ins):
        if op.startswith("BRA") and isinstance(tgt, int) and tgt <= i:
            ops = [o for _, o, _ in ins[tgt:i + 1]]
            if sum(o.startswith("LDG") for o in ops) >= FACE_LOADS and \
                    "MUFU.RCP" in ops:
                loops.append((i - tgt, tgt, i))
    if not loops:
        return {}
    _, head, back = min(loops)
    walk, pc = [], head
    while len(walk) < 4 * (back - head + 1):
        pred, op, tgt = ins[pc]
        walk.append((op, tgt))
        if pc == back:
            break
        skips_slow_path = pred and isinstance(tgt, int) and \
            pc < tgt <= pc + 1 + SLOW_PATH_MAX and \
            any(o.startswith("CALL") for _, o, _ in ins[pc + 1:tgt])
        if op == "BRA" and isinstance(tgt, int) and (not pred or
                                                     skips_slow_path):
            pc = tgt
        else:
            pc += 1
    ops = [o for o, _ in walk]
    faces = sum(o.startswith("LDG") for o in ops) // FACE_LOADS
    if not faces:
        return {}
    hist, opened, regions = {}, {}, []
    for a, (op, args) in enumerate(walk):
        hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        if op == "BSSY":
            opened.setdefault(args.split(",")[0], []).append(a)
        elif op == "BSYNC" and opened.get(args):
            b = opened[args].pop()
            if "MUFU.RCP" in ops[b:a + 1]:
                regions.append(a - b + 1)
    per_face = {k: v / faces for k, v in sorted(hist.items())}
    return {"faces a trip": faces, "per face": per_face,
            "total": len(walk) / faces,
            "float": sum(v for k, v in per_face.items() if k in FLOAT_OPS),
            "atan2f": max(regions, default=0) / faces}


def _kernel_ms(launch, reps: int = 20) -> float:
    """Median over 5 runs of the CUDA-event time a launch of ``reps``
    back-to-back launches, queued behind a device sleep."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _inputs(dev):
    """{name: points}, and the subdiv-5 body's cluster tables on ``dev``."""
    from icon_tpu_torch.kernels import winding as kw
    from icon_tpu_torch.ops.sdf_fast import build_winding_clusters
    from icon_tpu_torch.utils.synthetic import synthetic_body
    verts, faces = synthetic_body(subdiv=5)
    rng = np.random.RandomState(7)
    d = rng.normal(size=(CAP, 3))
    d *= (0.02 * rng.uniform(0, 1, (CAP, 1)) ** (1 / 3)
          / np.linalg.norm(d, axis=1, keepdims=True))
    cap = (verts[rng.randint(0, len(verts), CAP)] + d).astype(np.float32)
    g = torch.linspace(0.0, 1.0, LATTICE, device=dev)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    lattice = torch.stack([xx, yy, zz], -1).reshape(-1, 3) * \
        torch.tensor([2.0, -2.0, 2.0], device=dev) + \
        torch.tensor([-1.0, 1.0, -1.0], device=dev)
    cf, cm = build_winding_clusters(verts, faces)
    table, ctri, mask = kw.cluster_table(
        torch.as_tensor(verts, device=dev),
        torch.as_tensor(faces, dtype=torch.int64, device=dev),
        torch.as_tensor(cf, device=dev), torch.as_tensor(cm, device=dev))
    pts = {"level 0 lattice": lattice.contiguous(),
           "cap": torch.as_tensor(cap, device=dev)}
    return pts, (table, ctri.contiguous(), mask)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    from icon_tpu_torch.kernels import winding as kw
    from icon_tpu_torch.kernels.build import build, find_nvcc
    lib = build()["winding.cu"]
    cuobjdump = osp.join(osp.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    funcs = sass_functions(sass, "fast_winding_kernelILi8E")
    if len(funcs) != 1:
        raise SystemExit(f"{len(funcs)} functions of the K <= 256 instance")
    loop = face_loop(next(iter(funcs.values())))
    if not loop:
        raise SystemExit("no face loop found in the SASS")
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], "face loop": loop}
    print(json.dumps(out), flush=True)

    dev = torch.device("cuda", 0)
    pts, (table, ctri, mask) = _inputs(dev)
    K, M = mask.shape
    m = min(16, K)
    faces_each = float(mask.sum()) / K
    tiles = kw.face_tiles(ctri, mask)
    out["K"], out["M"], out["m"], out["faces a cluster"] = K, M, m, \
        faces_each
    out["instance"] = kw.kernel_info(K)
    per_face = {"operations": WIND_OPS_PER_FACE - 1 + loop["atan2f"],
                "face loop": loop["total"]}
    for name, p in pts.items():
        n = p.shape[0]
        w = torch.empty(n, dtype=torch.float32, device=dev)
        ms = _kernel_ms(lambda: kw._launch(p, table, tiles, M, m, w))
        before = kw.launches
        wrapper_ms = _kernel_ms(lambda: kw.fast_winding_kernel(
            p, table, ctri, mask, m))
        kw.launches = before
        bound_ms = n * (K * WIND_OPS_PER_CLUSTER + m * faces_each *
                        WIND_OPS_PER_FACE) / FP32_PEAK * 1e3
        row = {"N": n, "kernel_ms": ms, "wrapper_ms": wrapper_ms,
               "bound_ms": bound_ms, "bound share": bound_ms / ms}
        for what, c in per_face.items():
            ceil = n * (K * WIND_OPS_PER_CLUSTER + m * faces_each * c) / \
                FP32_INSTR_RATE * 1e3
            row[f"ceiling ms ({what})"] = ceil
            row[f"ceiling share ({what})"] = ceil / ms
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
