"""The indexed marcher's kernels of two checkouts, parent and change, in one
process on one CUDA card.

Inputs: ``chip_smoke.py`` phase 17c's grid (the crossing-column frame's
final 257^3 level at res 256, bench.py's icon-filter widths, seed 0, the
subdiv-5 synthetic body), sliced by one, and its 513^3 align_corners
trilinear upsample. The change is this tree; ``--parent DIR`` names
another checkout, whose ``icon_tpu_torch`` is imported as a package copy
of its own and builds its kernels into its own ``_build``. Only the public
wrappers are called (``mt_emit``, ``mt_index``,
``marching_tetrahedra_indexed``), so any two checkouts compare. At each
shape, for each version in ``--order``:

1. each wrapper's device time a call, by kernel (and memset):
   torch.profiler's CUDA table over 20 calls, with the launches it
   recorded; ``kernels`` sums the marching library's, ``fills`` PyTorch's
   own (the wrapper's output fills);
2. each wrapper's and the whole ``marching_tetrahedra_indexed``'s time a
   call: the median CUDA-event time of one call, its host dispatch
   included;
3. before the rounds, each version's outputs held to this tree's plain
   versions: counts, emitted slots, faces and the vertex table's live rows
   identical.

``chip_smoke.py`` phase 17c times this tree's kernels alone, beside their
bounds, the plain versions and ``torch.unique``. Usage, from the
repository root on the card:

    python3 -m icon_tpu_torch.kernels.profile_marching --parent DIR \\
        [--order parent,change,change,parent] [--shapes 257,513] \\
        [--out FILE]
"""

import argparse
import importlib
import json
import os.path as osp
import statistics
import subprocess
import sys

import torch

PKG = "icon_tpu_torch"
SHAPES = {257: dict(max_cells=1 << 18, max_tris=1 << 20, max_verts=1 << 21),
          513: dict(max_cells=1 << 20, max_tris=1 << 21, max_verts=1 << 21)}
REPS = 20


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def load_checkout(root: str, names, bind) -> tuple:
    """The modules ``names`` (dotted, under the package) of the checkout at
    ``root``, a package copy of its own: imported, and ``bind(*modules)``
    called to build and bind their kernels, while its modules stand in
    ``sys.modules``; then this tree's modules put back."""
    root = osp.abspath(root)
    mine = _package_modules()
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        mods = tuple(importlib.import_module(f"{PKG}.{n}") for n in names)
        if not all(m.__file__.startswith(root) for m in mods):
            raise RuntimeError(f"{root} holds no {PKG}")
        bind(*mods)
    finally:
        sys.path.remove(root)
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(mine)
    return mods


def call_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of one ``fn()`` call, its host dispatch
    included (after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, reps: int = REPS) -> dict:
    """{"kernels": ms, "fills": ms, "launches": {name: [ms, recorded]}}:
    the device time a call of ``fn()`` over ``reps`` calls, by kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"kernels": 0.0, "fills": 0.0, "launches": {}}
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        ms = e.device_time_total / reps / 1e3
        out["fills" if "at::" in e.key else "kernels"] += ms
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        out["launches"][name[-60:]] = [round(ms, 5), e.count]
    return out


def column_grid(dev):
    """chip_smoke.py phase 17c's 257^3 grid: the crossing-column frame's
    final level."""
    import numpy as np
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=512, n_samples=64, subdiv=5)
    frame = build_frame(cfg, seeded_state(cfg, 0), batch, 256, dev,
                        sign="columns")
    with torch.no_grad():
        cz, _ = frame.columns()
        occ, _ = frame.engine(frame.query_fn, query_args=(cz,
                                                          frame.features()))
    return occ


def profile_shape(versions, order, fine, kw) -> dict:
    from icon_tpu_torch.kernels import marching as km
    from icon_tpu_torch.recon import marching as PM
    mt, mv = kw["max_tris"], kw["max_verts"]
    shape = tuple(fine.shape)
    cx, cy, cz, _, _, n_cells, _ = PM._active_cells(fine, 0.5,
                                                    kw["max_cells"], None)
    pe = km.mt_emit_plain(fine, cx, cy, cz, n_cells, 0.5, mt)
    pi = km.mt_index_plain(*pe[:5], mv, shape)
    nt, nu = int(pe[4]), int(pi[4])
    nv = min(nu, mv)
    res = {"cells": int(n_cells), "triangles": nt, "vertices": nu, **kw}
    calls = {}
    for name, (vkm, vpm) in versions.items():
        e = vkm.mt_emit(fine, cx, cy, cz, n_cells, 0.5, mt)
        i = vkm.mt_index(*e[:5], mv, shape)
        torch.cuda.synchronize()
        same = ([int(e[4]), int(e[5]), int(i[4])] == [nt, int(pe[5]), nu]
                and torch.equal(e[3], pe[3]) and torch.equal(i[3], pi[3])
                and all(torch.equal(e[k][:nt], pe[k][:nt]) and
                        torch.equal(i[k][:nv], pi[k][:nv])
                        for k in range(3)))
        if not same:
            raise AssertionError(f"{name}'s kernels disagree with plain")
        calls[name] = {
            "mt_emit": lambda vkm=vkm: vkm.mt_emit(fine, cx, cy, cz, n_cells,
                                                   0.5, mt),
            "mt_index": lambda vkm=vkm, e=e: vkm.mt_index(*e[:5], mv,
                                                          shape),
            "marching_tetrahedra_indexed":
                lambda vpm=vpm: vpm.marching_tetrahedra_indexed(fine, **kw)}
    rounds = []
    for name in order:
        fns = calls[name]
        rounds.append({
            "version": name,
            "device": {k: device_split(fns[k])
                       for k in ("mt_emit", "mt_index")},
            "call_ms": {k: call_ms(fn) for k, fn in fns.items()}})
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
        print("profile_marching: no CUDA card", file=sys.stderr)
        return 2
    order = args.order.split(",")
    if "parent" in order and not args.parent:
        ap.error("--parent is needed for the parent's rounds")
    from icon_tpu_torch.kernels import marching as km
    from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
    from icon_tpu_torch.recon import marching as PM
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    versions = {}
    if "parent" in order:
        versions["parent"] = load_checkout(
            args.parent, ("kernels.marching", "recon.marching"),
            lambda km, pm: km._lib_on(dev))
    if "change" in order:
        km._lib_on(dev)
        versions["change"] = (km, PM)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    occ = column_grid(dev)
    result = {"card": card, "order": order}
    for n in (int(s) for s in args.shapes.split(",")):
        grid = occ if n == 257 else resize3d_trilinear_align_corners(
            occ[None, None], (n,) * 3)[0, 0]
        fine = grid[1:, 1:, 1:].contiguous()
        del grid
        result[str(n)] = profile_shape(versions, order, fine, SHAPES[n])
        del fine
        torch.cuda.empty_cache()
        print(json.dumps({str(n): result[str(n)]}), flush=True)
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
