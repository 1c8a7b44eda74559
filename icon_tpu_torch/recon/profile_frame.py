"""Where the time of a serving frame goes, on one CUDA card.

Builds the frame chip_smoke.py runs at full width (bench.py's icon-filter
config, the subdiv-5 body, res 256, seeded weights), warms it up, then:

1. per-stage host-clock times with a synchronize between stages, median of
   5; ``--frame plain`` (512^2 normals given): filter, crossing columns,
   engine, marching, pack (the decode on the card), decode (the wait for
   the copy and the host's slicing); ``--frame normalnet`` (512^2 image,
   the published NormalNet widths): the body's normal renders, NormalNet,
   filter, vertex visibility (with projection and cmap), crossing columns,
   engine, marching, pack, decode;
2. a torch.profiler trace of 2 frames: device time by kernel (top 25) and
   the device's busy share of the wall time.

``--serve N`` measures the serving loop instead of 1. and 2. (plain or
NormalNet frame): s/image of the sequential frame (median of 5), of the
sequential frame and of bench.py's same-thread 2-deep loop over N frames
back to back (each also split into ``compute()``'s dispatch and the
unpack's wait), of ``Frame.serve`` and of ``serve`` while every pack
token is held (as a checker that keeps them does); then the
dispatching thread's time in ``serve`` by stage (the rest of
``compute()``, the march, the pack with its ``lattice_decode`` launch and
its ``HostCopy`` allocations, the wait in ``finish`` for the worker, any
re-pack) and the worker's (the wait for the copy, the decode), in ms a
frame, with the dispatching thread's CPU time; and, for the plain frame,
each stage's dispatch from an idle and from a busy device (a sleep
kernel before it), which shows a stage that waits for the card, and the
engine from a busy device under torch.profiler (the host call that
absorbs the wait, with its callers; the table goes to ``--out``). It reads
only ``AutoMarcher``, ``HostCopy`` and ``Future`` and so also runs
against an older tree of the package on the import path.

The plain and NormalNet profiles begin with the kernel launches of one
warm frame under torch.profiler: the host's launch calls
(``cudaLaunchKernel`` and kin) and graph launches (``cudaGraphLaunch``)
in the whole frame, in the engine and in the body-feature calls
(``ops/sdf_fast.py:cal_sdf_batch_fast``, with their count; a replayed
level's calls are not dispatched from the host), and the kernels the
device ran. It too reads only names that older trees have (the engine is
called as the frame calls it, with ``graph_levels`` where
``Frame.graphs`` is set). ``--launches`` stops after them. ``--serve``
also gives the peak memory of a served window.

``--frame fit`` profiles the fit frame's two loops instead (their stage
split is chip_smoke.py's phase 9): 5 iterations of the SMPL fit (512^2,
the subdiv-5 SMPL-X-layout body, the published NormalNet widths) and 5 of
the cloth refinement of the remeshed res-256 reconstruction, each traced
after a warm-up: wall time, device busy share and device time by kernel.

Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.recon.profile_frame [--frame normalnet|fit]
        [--out FILE] [--serve N | --launches]

TF32 stays off, as in chip_smoke.py, so the numbers describe the same
float32 frame.
"""

import argparse
import collections
import concurrent.futures
import os
import os.path as osp
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch


def engine_kw(fr) -> dict:
    """The frame's own engine call: its levels replayed as CUDA graphs
    where the frame does so (``Frame.graphs``; older trees dispatch
    eagerly and lack the name)."""
    return {"graph_levels": True} if getattr(fr, "graphs", False) else {}


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
            fr.query_fn, query_args=(cz, feats), **engine_kw(fr)))
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
            fr.query_fn, query_args=(smpl, feats), **engine_kw(fr)))
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


class Spans:
    """Wall time a thread spends in patched callables, by name (the
    worker's prefixed ``worker``), while entered; patches are undone on
    exit."""

    def __init__(self):
        self.ms = collections.defaultdict(float)
        self.undo = []
        self.main = threading.get_ident()

    def patch(self, owner, attr: str, name: str):
        if not hasattr(owner, attr):
            return
        orig = getattr(owner, attr)
        ms, main = self.ms, self.main

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                key = name if threading.get_ident() == main else \
                    f"worker {name}"
                ms[key] += (time.perf_counter() - t0) * 1e3

        setattr(owner, attr, timed)
        self.undo.append((owner, attr, orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.undo):
            setattr(owner, attr, orig)


def serve_split(fr, n: int):
    """Lines: the serving loop's s/image under its variants, then where
    the dispatching and the worker thread spend a served frame."""
    from icon_tpu_torch.recon import engine, marching
    AM = marching.AutoMarcher

    def per_image(fn, frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) / frames

    def frame_s():
        return per_image(fr.frame, 1)

    def loop(two_deep: bool):
        """(s/image, compute() ms, its thread CPU ms, unpack ms a frame)
        of ``n`` frames back to back, each unpacked at once or after the
        next is enqueued."""
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        dispatch = wait = cpu = 0.0
        pending = None
        for _ in range(n):
            t0, c0 = time.perf_counter(), time.thread_time()
            token = fr.compute()[0]
            t1 = time.perf_counter()
            cpu += time.thread_time() - c0
            if two_deep:
                if pending is not None:
                    fr.marcher.unpack(pending)
                pending = token
            else:
                fr.marcher.unpack(token)
            dispatch += t1 - t0
            wait += time.perf_counter() - t1
        if pending is not None:
            fr.marcher.unpack(pending)
        return ((time.perf_counter() - t_all) / n, dispatch / n * 1e3,
                cpu / n * 1e3, wait / n * 1e3)

    def held():
        tokens, orig = [], AM.pack

        def pack(self, *args, **kw):
            tokens.append(orig(self, *args, **kw))
            return tokens[-1]

        AM.pack = pack
        try:
            fr.serve(n)
        finally:
            AM.pack = orig

    for _ in range(2):
        fr.serve(n)
    seq = statistics.median(frame_s() for _ in range(5))
    lines = [f"serving loop, s/image over {n} frames: sequential {seq:.4f} "
             f"(median of 5)"]
    for name, two_deep in (("sequential", False),
                           ("same-thread 2-deep", True)):
        s_img, disp, cpu, wait = loop(two_deep)
        lines.append(f"  {name}: {s_img:.4f}; a frame compute() "
                     f"{disp:.3f} ms (thread CPU {cpu:.3f}), unpack "
                     f"{wait:.3f} ms")
    for name, fn in (("served", lambda: fr.serve(n)),
                     ("served, tokens held", held),
                     ("served again", lambda: fr.serve(n))):
        lines.append(f"  {name}: {per_image(fn, n):.4f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr.serve(n)
    torch.cuda.synchronize()
    lines.append(f"  peak memory of a served window of {n} frames: "
                 f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
                 f"allocated, {torch.cuda.max_memory_reserved() / 2 ** 30:.3f}"
                 f" GiB reserved")

    with Spans() as sp:
        sp.patch(AM, "__call__", "march")
        sp.patch(AM, "pack", "pack")
        sp.patch(AM, "decode", "decode")
        sp.patch(AM, "repack", "repack")
        sp.patch(marching, "lattice_decode", "pack: lattice_decode")
        sp.patch(engine.HostCopy, "__init__", "HostCopy alloc + copy (march, pack)")
        sp.patch(engine.HostCopy, "wait", "HostCopy.wait")
        sp.patch(concurrent.futures.Future, "result", "finish: result()")
        c0 = time.thread_time()
        wall = per_image(lambda: fr.serve(n), n) * 1e3
        cpu = (time.thread_time() - c0) / n * 1e3
    lines.append(f"served frame split (ms a frame, {wall:.3f} wall, the "
                 f"dispatching thread's CPU {cpu:.3f}; nested spans "
                 f"indented under their callers):")
    ms = {k: v / n for k, v in sp.ms.items()}
    own = [k for k in ("march", "pack", "finish: result()", "repack")
           if k in ms]
    rest = wall - sum(ms[k] for k in own)
    lines.append(f"  dispatch of columns, filter, engine (the rest) "
                 f"{rest:.3f}")
    for k in own:
        lines.append(f"  {k} {ms[k]:.3f}")
        if k == "pack":
            lines += [f"    {j} {ms[j]:.3f}" for j in (
                "pack: lattice_decode", "HostCopy alloc + copy (march, pack)",
                "HostCopy.wait") if j in ms]
    lines += [f"  {k} {v:.3f}" for k, v in ms.items()
              if k.startswith("worker")]
    return lines


def busy_dispatch(fr, sleep_ms: float = 100.0):
    """Lines: each stage of the plain frame's ``compute()`` timed on the
    host clock from an idle device and from a device kept busy by a
    ``sleep_ms`` sleep kernel enqueued just before it (median of 3). A
    stage whose launches never wait for the card takes the same time from
    both; one that waits for the stream takes the sleep's time more."""
    c = int(1e8)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.cuda._sleep(c)
    e1.record()
    e1.synchronize()
    c = int(c * sleep_ms / e0.elapsed_time(e1))

    def run(busy: bool):
        t = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            if busy:
                torch.cuda._sleep(c)
            t0 = time.perf_counter()
            out = fn()
            t[name] = (time.perf_counter() - t0) * 1e3
            return out

        with torch.no_grad():
            cz, _ = timed("columns", fr.columns)
            feats = timed("filter", fr.features)
            occ, st = timed("engine", lambda: fr.engine(
                fr.query_fn, query_args=(cz, feats), **engine_kw(fr)))
            mesh = timed("march", lambda: fr.marcher(
                occ, coarse_occ=st["coarse_occ"]))
            tok = timed("pack", lambda: fr.marcher.pack(mesh))
            fr.marcher.unpack(tok)
        return t

    runs = {b: [run(b) for _ in range(3)] for b in (False, True)}
    med = {b: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for b, rs in runs.items()}
    lines = [f"stage dispatch from an idle / a busy device ({sleep_ms:.0f} "
             f"ms sleep kernel before each), ms, median of 3: " +
             ", ".join(f"{k} {med[False][k]:.3f} / {med[True][k]:.3f}"
                       for k in med[False])]

    # the engine from a busy device under torch.profiler: the host call
    # that absorbs the sleep has the largest self CPU time
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        cz, _ = fr.columns()
        feats = fr.features()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            torch.cuda._sleep(c)
            fr.engine(fr.query_fn, query_args=(cz, feats), **engine_kw(fr))
        torch.cuda.synchronize()
    top = sorted((e for e in prof.key_averages()
                  if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    lines.append("the engine from a busy device, host calls by self CPU "
                 "time (ms): " + ", ".join(
                     f"{e.key} {e.self_cpu_time_total / 1e3:.3f} x{e.count}"
                     for e in top))
    worst = max(prof.events(), key=lambda e: e.self_cpu_time_total)
    chain, e = [], worst.cpu_parent
    while e is not None and len(chain) < 24:
        chain.append(e.name)
        e = e.cpu_parent
    lines.append(f"its longest single call: {worst.name} "
                 f"{worst.self_cpu_time_total / 1e3:.3f} ms, inside " +
                 " <- ".join(chain))
    lines.append(prof.key_averages().table(
        sort_by="self_cpu_time_total", row_limit=15,
        max_name_column_width=60))
    return lines


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


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel")
GRAPH_LAUNCH = "cudaGraphLaunch"


def launch_counts(fr):
    """Lines: the kernel launches of one warm ``fr.frame()`` under
    torch.profiler: the host's launch calls in all, in the engine and in
    the body-feature calls (each call a span of its own), and the kernels
    the device ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from icon_tpu_torch.ops import sdf_fast
    calls = [0]

    def spanned(owner, attr, span):
        orig = getattr(owner, attr)

        def fn(*args, **kw):
            if span == "body features":
                calls[0] += 1
            with record_function(span):
                return orig(*args, **kw)

        setattr(owner, attr, fn)
        return owner, attr, orig

    undo = [spanned(sdf_fast, "cal_sdf_batch_fast", "body features"),
            spanned(type(fr.engine), "__call__", "engine")]
    try:
        fr.frame()
        torch.cuda.synchronize()
        calls[0] = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fr.frame()
            torch.cuda.synchronize()
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    events = prof.events()

    def within(e, span):
        while e is not None:
            if e.name == span:
                return True
            e = e.cpu_parent
        return False

    launches = [e for e in events if e.name.startswith(LAUNCH_CALLS)]
    graphs = [e for e in events if e.name.startswith(GRAPH_LAUNCH)]
    engine = sum(within(e, "engine") for e in launches)
    engine_graphs = sum(within(e, "engine") for e in graphs)
    body = sum(within(e, "body features") for e in launches)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    return [f"launches of one warm frame: {len(launches)} launch calls "
            f"(engine {engine}; {calls[0]} body-feature calls {body}, "
            f"{body / max(calls[0], 1):.1f} a call) and {len(graphs)} "
            f"graph launches (engine {engine_graphs}), {kernels} device "
            f"kernels"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frame", choices=("plain", "normalnet", "fit"),
                    default="plain", help="which serving frame")
    ap.add_argument("--out", default="profile_frame.txt",
                    help="where the stage split and kernel table go")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="measure the serving loop over N frames instead")
    ap.add_argument("--launches", action="store_true",
                    help="count one warm frame's launches and stop")
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
    counts = launch_counts(fr)
    head = [f"card: {card}; torch {torch.__version__}; TF32 off; "
            f"{args.frame} frame"] + counts
    if args.launches:
        return write(head, args.out, head)
    if args.serve:
        lines = [f"card: {card}; torch {torch.__version__}; TF32 off; "
                 f"{args.frame} frame"] + counts + \
            serve_split(fr, args.serve)
        head = list(lines)
        if args.frame == "plain":
            lines += busy_dispatch(fr)
            head = lines[:-1]
        return write(lines, args.out, head)

    runs = [split(fr) for _ in range(5)]
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    total = sum(stages.values())
    lines = [f"card: {card}; torch {torch.__version__}; TF32 off; "
             f"{args.frame} frame"] + counts + \
        ["stage medians of 5 synchronized frames (ms):"]
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
    return write(lines, args.out, lines[:len(stages) + len(counts) + 4])


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
