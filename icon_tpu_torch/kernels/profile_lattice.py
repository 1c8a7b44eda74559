"""The serving lattice's three kernels of two checkouts, parent and change,
in one process on one CUDA card.

Inputs: ``chip_smoke.py`` phase 19's. At 257^3 the crossing-column
frame's final level (res 256, bench.py's icon-filter widths, seed 0, the
subdiv-5 synthetic body) sliced by one, with its coarse grid, 2^18 cells
and 2^19 vertices; at 513^3 the virtual final level of the clothed
human's engine at res 512 (``lattice_cells`` on its materialized
upsample, the emit on the cells ``marching_lattice_virtual`` hands it),
2^21 cells and vertices. The change is this tree; ``--parent DIR`` names
another checkout, whose ``icon_tpu_torch`` is imported as a package copy
of its own and builds its kernels into its own ``_build``. Only the public
wrappers are called (``lattice_cells``, ``lattice_emit``,
``lattice_decode``), each version's decode on its own emit's lattice, so
any two checkouts compare. At each shape, for each version in
``--order``:

1. each wrapper's device time a call alone: 20 calls queued behind a
   device sleep, CUDA events around them, the median of 5 (phase 19's
   ``kernel_ms``; memsets included);
2. the same calls' device time by kernel (and memset) from
   torch.profiler's CUDA table;
3. each wrapper's host dispatch a call (host clock, the median of 5 runs
   of 20 calls);
4. before the rounds, each version's outputs held bit for bit to this
   tree's plain twins (the cells, the emit's first 8 fields, the decode's
   header and the rows its counts cover).

Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.kernels.profile_lattice --parent DIR \\
        [--order parent,change,change,parent] [--shapes 257,513] \\
        [--out FILE]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from icon_tpu_torch.kernels.profile_marching import (device_split,
                                                     load_checkout)

KERNELS = ("lattice_cells", "lattice_emit", "lattice_decode")
SLEEP = 40_000_000        # cycles: 20 wrapper calls queue behind it
REPS = 20


def alone_ms(fn, reps: int = REPS) -> float:
    """Median over 5 runs of the CUDA-event time a call of ``reps``
    back-to-back ``fn()`` calls, queued behind a device sleep so that the
    host's dispatch does not reach the timed window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(SLEEP)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def dispatch_ms(fn, reps: int = REPS) -> float:
    """The host's time a call of ``fn()``: the median of 5 runs of
    ``reps`` calls."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs)


def inputs(dev, n: int):
    """(fine, coarse, max_cells, max_verts, emit args or None) of phase
    19 at ``n``^3."""
    import numpy as np
    from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
    from icon_tpu_torch.recon import marching as PM
    from icon_tpu_torch.recon.engine import (ReconEngine,
                                             reconstruction_resolutions)
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import (clothed_human_occ,
                                                synthetic_icon_batch)
    if n == 257:
        cfg = bench_config()
        batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                     image_size=512, n_samples=64, subdiv=5)
        frame = build_frame(cfg, seeded_state(cfg, 0), batch, 256, dev,
                            sign="columns")
        with torch.no_grad():
            cz, _ = frame.columns()
            occ, st = frame.engine(frame.query_fn,
                                   query_args=(cz, frame.features()))
        return occ[1:, 1:, 1:], st["coarse_occ"], 1 << 18, 1 << 19, None
    res = n - 1
    eng = ReconEngine(reconstruction_resolutions(res), virtual_final=True,
                      device=dev)
    with torch.no_grad():
        coarse, _ = eng(lambda p: clothed_human_occ(p)[..., None])
    mc = mv = (1 << 19) * (res // 256) ** 2
    recorded, emit = [], PM.lattice_emit
    PM.lattice_emit = lambda *a: recorded.append(a) or emit(*a)
    try:
        PM.marching_lattice_virtual(coarse, max_cells=mc, max_verts=mv,
                                    max_candidates=mc)
    finally:
        PM.lattice_emit = emit
    fine = resize3d_trilinear_align_corners(
        coarse[None, None], (2 * coarse.shape[0] - 1,) * 3)[0, 0, 1:, 1:, 1:]
    return fine, coarse, mc, mv, recorded[0]


def profile_shape(versions, order, n, dev) -> dict:
    from icon_tpu_torch.kernels import lattice as kl
    fine, coarse, mc, mv, emit_args = inputs(dev, n)
    cells = kl.lattice_cells_plain(fine, 0.5, mc, coarse, mc)
    if emit_args is None:
        emit_args = (cells.cvals, cells.cx, cells.cy, cells.cz,
                     cells.cell_idx, cells.n_cells, cells.n_cells_total,
                     tuple(fine.shape), 0.5, mv)
    lat = kl.lattice_emit_plain(*emit_args)
    nvb, nfb = kl.decode_sizes(lat)
    dec = kl.lattice_decode_plain(lat, nvb, nfb)
    nv, nf = int(dec[0]), int(dec[1])
    fo = kl.HEADER + 3 * nvb
    res = {"cells": int(cells.n_cells), "vertices": nv, "faces": nf,
           "max_cells": mc, "max_verts": mv}
    calls = {}
    for name, vkl in versions.items():
        c = vkl.lattice_cells(fine, 0.5, mc, coarse, mc)
        out = vkl.lattice_emit(*emit_args)
        buf = vkl.lattice_decode(out, nvb, nfb)
        torch.cuda.synchronize()
        same = (all(torch.equal(a, b) for a, b in zip(c, cells)) and
                all(torch.equal(a, b) for a, b in zip(out[:8], lat[:8])) and
                torch.equal(buf[:kl.HEADER + 3 * nv],
                            dec[:kl.HEADER + 3 * nv]) and
                torch.equal(buf[fo:fo + 3 * nf], dec[fo:fo + 3 * nf]))
        if not same:
            raise AssertionError(f"{name}'s lattice kernels disagree with "
                                 f"the plain twins at {n}^3")
        calls[name] = {
            "lattice_cells": lambda vkl=vkl: vkl.lattice_cells(
                fine, 0.5, mc, coarse, mc),
            "lattice_emit": lambda vkl=vkl: vkl.lattice_emit(*emit_args),
            "lattice_decode": lambda vkl=vkl, out=out: vkl.lattice_decode(
                out, nvb, nfb)}
    rounds = []
    for name in order:
        fns = calls[name]
        rounds.append({
            "version": name,
            "alone_ms": {k: alone_ms(fns[k]) for k in KERNELS},
            "device": {k: device_split(fns[k]) for k in KERNELS},
            "dispatch_ms": {k: dispatch_ms(fns[k]) for k in KERNELS}})
        alone, host = (
            {k: round(v, 4) for k, v in rounds[-1][key].items()}
            for key in ("alone_ms", "dispatch_ms"))
        print(f"[{n}^3] {name}: alone {alone} ms; host dispatch {host} ms "
              f"a call", flush=True)
    res["rounds"] = rounds
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--shapes", default="257,513")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lattice: no CUDA card", file=sys.stderr)
        return 2
    order = args.order.split(",")
    if "parent" in order and not args.parent:
        ap.error("--parent is needed for the parent's rounds")
    from icon_tpu_torch.kernels import lattice as kl
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    versions = {}
    if "parent" in order:
        versions["parent"], = load_checkout(
            args.parent, ("kernels.lattice",), lambda m: m._lib_on(dev))
    if "change" in order:
        kl._lib_on(dev)
        versions["change"] = kl
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"card": card, "order": order}
    for n in (int(s) for s in args.shapes.split(",")):
        result[str(n)] = profile_shape(versions, order, n, dev)
        torch.cuda.empty_cache()
        print(json.dumps({str(n): {k: v for k, v in result[str(n)].items()
                                   if k != "rounds"}}), flush=True)
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
