"""Where a geometry training step's time goes on the card, at the published
width (``data/fixture.py:train_config``: batch 4, 512^2, 8,000 samples an
item, the 2-stack hourglass and the 13-512-256-128-1 MLP).

    python3 -m icon_tpu_torch.training.profile_step --out prof.txt

Writes the fixture (2 subjects x 3 views) to a temporary directory, loads
one batch with the loader's 4 worker processes (timed), then on one fixed
batch: the step's parts by CUDA events (the filter forward, the query with
the body features, the loss's backward, the optimizer) and the whole
step's median of 5 under torch's defaults (cuDNN may use TF32), then with
TF32 off (the parity setting) without and with ``cudnn.benchmark``, and
one step under ``torch.profiler`` with TF32 off (its busiest CUDA kernels
and the kernels' share of the step) into ``--out``. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

import torch


def _events(fn, reps: int = 5):
    """Median ms of ``fn()`` by CUDA events over ``reps`` runs, after one."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_step.txt")
    args = ap.parse_args(argv)

    from icon_tpu_torch.data.datasets import PIFuDataset, make_loader
    from icon_tpu_torch.data.fixture import (make_synthetic_dataset,
                                             train_config)
    from icon_tpu_torch.kernels import build
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.training.train_step import (batch_to, make_optimizer,
                                                    train_step)
    dev = torch.device("cuda", 0)
    build.build()
    out = {"card": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as d:
        make_synthetic_dataset(d, n_subjects=2, n_views=3, size=512,
                               vis_res=1024, device=dev)
        cfg = train_config(d)
        t0 = time.perf_counter()
        it = iter(make_loader(PIFuDataset(cfg), batch_size=4, num_workers=4))
        host = next(it)
        it.close()
        out["load_batch_s"] = time.perf_counter() - t0
    batch = batch_to(host, dev)
    torch.manual_seed(0)
    net = HGPIFuNet(cfg, normal_net=False).to(dev).train()
    opt = make_optimizer(net, cfg)

    def parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        opt.zero_grad()
        ev[0].record()
        feats = net.filter(batch)
        ev[1].record()
        smpl = {k: v for k, v in batch.items()
                if k.startswith(("smpl_", "voxel_"))}
        preds = net.query(feats, batch["sample"], batch["calib"], smpl)
        loss = sum(torch.mean((p - batch["label"]) ** 2) for p in preds)
        ev[2].record()
        (loss / len(preds)).backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    out["defaults"] = {"cudnn_tf32": torch.backends.cudnn.allow_tf32,
                       "matmul_tf32": torch.backends.cuda.matmul.allow_tf32}
    parts()
    split = [statistics.median(x) for x in zip(*(parts() for _ in range(5)))]
    out["parts_ms_defaults"] = dict(zip(("filter", "query", "backward",
                                         "optimizer"), split))

    def step():
        train_step(net, opt, batch)

    out["step_ms_defaults"] = _events(step)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out["step_ms_tf32_off"] = _events(step)
    torch.backends.cudnn.benchmark = True
    out["step_ms_tf32_off_cudnn_benchmark"] = _events(step)
    torch.backends.cudnn.benchmark = False
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(net, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "Buffer" not in e.key]          # the profiler's own
    out["profiled_step_ms"] = wall_ms
    out["kernel_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    out["kernel_share"] = out["kernel_ms"] / wall_ms
    out["kernel_launches"] = sum(e.count for e in kernels)
    with open(args.out, "w") as fh:
        fh.write(json.dumps(out) + "\n")
        fh.write(events.table(sort_by="self_device_time_total",
                              row_limit=25))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
