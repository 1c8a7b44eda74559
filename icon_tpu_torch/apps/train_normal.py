"""The NormalNet trainer's CLI (``icon_tpu.apps.train_normal``; reference
apps/train-normal.py).

    python -m icon_tpu_torch.apps.train_normal -cfg <yaml> [key value ...]
    python -m icon_tpu_torch.apps.train_normal -cfg <yaml> -resume \\
        [--max_steps N] [--vgg_ckpt vgg19.pth]

Training reads ``NormalDataset`` (image and body normals in, the scan's
normals as targets) through a ``DataLoader`` with ``cfg.num_threads``
worker processes and takes one Adam step over both generators a batch
(``training/normal_step.py``) on one device. After each epoch it validates
(the val split, else the test split, the last batch padded) and keeps the
top 3 checkpoints by validation loss plus the latest; ``-resume`` restores
the parameters, the Adam state and the step. The validation loss adds the
reference's no-grad VGG perceptual value when VGG19 weights exist
(``--vgg_ckpt``, default ``data/vgg/vgg19.pth``), so it compares with the
reference's. A log line every 20 steps; predicted-normal panels go to
``<ckpt_dir>/<name>/images`` every ``freq_show_train`` of an epoch.

``num_devices`` > 1 trains data parallel as ``apps/train.py`` does:
``make_mesh_for_batch``'s count of spawned ranks on this host, one a card
(CPU ranks when the caller asks for the CPU), each on its slice of every
global batch, the gradients averaged over the ranks each step (the
NormalNet's instance norm needs no global moments); rank 0 alone writes
checkpoints, logs and panels, and ``-resume`` reads after a barrier.

Every loader iterator a rank opens is closed in a ``finally``, so no
worker process outlives :func:`main`.
"""

from __future__ import annotations

import argparse
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from icon_tpu_torch.parallel import dist


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="icon_tpu_torch.apps.train_normal")
    ap.add_argument("-cfg", "--config_file", required=True)
    ap.add_argument("-resume", action="store_true")
    ap.add_argument("--max_steps", type=int, default=0)
    ap.add_argument("--vgg_ckpt", default="",
                    help="torchvision vgg19 .pth for the perceptual metric")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return ap.parse_args(argv)


def build_normal_net(cfg, device):
    from icon_tpu_torch.models.normalnet import NormalNet
    torch.manual_seed(0)
    return NormalNet(in_nml=cfg.net.in_nml or (
        ("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)),
        ngf=cfg.net.ngf, n_downsampling=cfg.net.n_downsampling,
        n_blocks=cfg.net.n_blocks).to(device)


def prediction_panels(net, batch: Dict) -> Dict[str, np.ndarray]:
    """The first item's inputs, its predicted normals in eval mode and
    their targets (reference Normal.py:117-129)."""
    from icon_tpu_torch.training.visuals import normal_pred_panels
    one = {k: v[:1] for k, v in batch.items()}
    was_training = net.training
    net.eval()
    with torch.no_grad():
        pred_f, pred_b = net(one)
    net.train(was_training)
    return normal_pred_panels({k: v.cpu().numpy() for k, v in one.items()},
                              pred_f.cpu().numpy(), pred_b.cpu().numpy())


def run_train(cfg, args, device) -> dict:
    from icon_tpu_torch.config import save_config
    from icon_tpu_torch.data.datasets import (NormalDataset, close_iter,
                                              make_loader)
    from icon_tpu_torch.models.vgg import load_vgg19
    from icon_tpu_torch.training.checkpoints import (CheckpointManager,
                                                     restore)
    from icon_tpu_torch.training.logging import MetricLogger
    from icon_tpu_torch.training.normal_step import (make_normal_optimizer,
                                                     normal_eval_step,
                                                     normal_train_step)
    from icon_tpu_torch.training.train_step import batch_to

    dataset = NormalDataset(cfg, split="train")
    if len(dataset) == 0:
        raise SystemExit(f"no training data under {cfg.dataset.root!r}")
    main_rank = dist.is_main_process()
    shard = {"process_index": dist.rank(), "process_count": dist.world()}
    loader = make_loader(dataset, batch_size=cfg.batch_size,
                         num_workers=cfg.num_threads, **shard)
    val_dataset = NormalDataset(cfg, split="val")
    if len(val_dataset) == 0:
        val_dataset = NormalDataset(cfg, split="test")
    val_loader = make_loader(val_dataset, batch_size=cfg.batch_size,
                             shuffle=False, num_workers=cfg.num_threads,
                             drop_last=False, pad_last=True, **shard) \
        if len(val_dataset) else None
    steps_per_epoch = len(loader)

    net = build_normal_net(cfg, device)
    vgg = load_vgg19(args.vgg_ckpt or None, device)
    if vgg is None:
        print("[train-normal] no VGG19 weights — val loss omits the "
              "reference's perceptual term (install data/vgg/vgg19.pth)",
              flush=True)
    opt = make_normal_optimizer(net, cfg, steps_per_epoch)
    ckpt_dir = osp.join(cfg.ckpt_dir, cfg.name)
    dist.barrier()                # -resume: every rank reads one index
    mgr = CheckpointManager(ckpt_dir, top_k=3)
    step = 0
    if args.resume and mgr.latest and osp.exists(mgr.latest):
        step = restore(net, opt, mgr.latest)
        print(f"[train-normal] resumed step {step} from {mgr.latest}",
              flush=True)
    logger = MetricLogger(ckpt_dir, "normal", enabled=main_rank)
    if main_rank and not osp.exists(osp.join(ckpt_dir, "cfg.yaml")):
        save_config(cfg, osp.join(ckpt_dir, "cfg.yaml"))
    show_every = max(int(cfg.freq_show_train * steps_per_epoch), 1)

    record = {"start_step": step, "vgg": vgg is not None, "losses": [],
              "step_s": [], "wait_s": [], "val_loss": [], "ckpts": [],
              "panels": []}
    iters = []
    t0 = time.perf_counter()
    try:
        for epoch in range(step // max(steps_per_epoch, 1), cfg.num_epoch):
            loader.set_epoch(epoch)
            iters.append(iter(loader))
            t_wait = time.perf_counter()
            for batch in iters[-1]:
                t_step = time.perf_counter()
                batch = batch_to(batch, device)
                metrics = normal_train_step(net, opt, batch)
                m = {k: float(v) for k, v in metrics.items()}
                step += 1
                record["wait_s"].append(t_step - t_wait)
                record["step_s"].append(time.perf_counter() - t_step)
                record["losses"].append(m["loss"])
                if step % 20 == 0:
                    logger.log(step, m)
                    print(f"epoch {epoch} step {step}: {m}", flush=True)
                if main_rank and step % show_every == 0:
                    record["panels"].append(logger.log_images(
                        step, prediction_panels(net, batch),
                        prefix="normal"))
                if args.max_steps and step >= args.max_steps:
                    break
                t_wait = time.perf_counter()
            close_iter(iters[-1])
            # validation epoch -> top-k checkpointing on the val loss
            val_loss = float("nan")
            if val_loader is not None:
                iters.append(iter(val_loader))
                vals = [float(normal_eval_step(
                    net, batch_to(vb, device), vgg)["loss"])
                    for vb in iters[-1]]
                val_loss = float(np.mean(vals)) if vals else float("nan")
                logger.log(step, {"val_loss": val_loss})
                print(f"epoch {epoch}: val_loss={val_loss:.4f}", flush=True)
            record["val_loss"].append(val_loss)
            if main_rank:
                record["ckpts"].append(mgr.save(
                    step, net, opt,
                    val_loss if np.isfinite(val_loss) else 1e9))
            if args.max_steps and step >= args.max_steps:
                break
    finally:
        for it in iters:
            close_iter(it)
        logger.close()
    record["steps"] = step
    record["ranks"] = dist.world()
    record["seconds"] = time.perf_counter() - t0
    record["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else None
    print(f"done: {step} steps in {record['seconds']:.0f}s "
          f"(best: {mgr.best})")
    return record


def _run_rank(argv: List[str], device) -> dict:
    """One rank of a ``num_devices`` run (``dist.run_on_mesh``)."""
    from icon_tpu_torch.config import load_config
    args = parse_args(argv)
    return run_train(load_config(args.config_file,
                                 overrides=args.opts or None), args, device)


def main(argv: Optional[List[str]] = None, device="cuda",
         timeout: Optional[float] = None) -> dict:
    """Run the CLI on ``device`` (the card unless the caller asks for the
    CPU); returns the run's record, rank 0's when several ranks train: the
    step count, the loss of each step, each step's seconds and the wait
    for its batch, the validation losses, whether they hold the VGG term,
    the checkpoints and the panels written, the rank count. ``timeout``:
    the seconds the spawned ranks of a ``num_devices`` run may take before
    they are killed (None: no limit)."""
    import sys
    from icon_tpu_torch.config import load_config
    from icon_tpu_torch.parallel.mesh import make_mesh_for_batch
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    cfg = load_config(args.config_file, overrides=args.opts or None)
    device = torch.device(device)
    if (cfg.num_devices or 1) > 1:
        mesh = make_mesh_for_batch(cfg.batch_size, cfg.num_devices, device)
        if len(mesh) > 1:
            print(f"[train-normal] {len(mesh)} ranks on {mesh}", flush=True)
            return dist.run_on_mesh(_run_rank, mesh, (argv,),
                                    timeout=timeout)
    return run_train(cfg, args, device)


if __name__ == "__main__":
    main()
