"""The geometry trainer's CLI (``icon_tpu.apps.train``; reference
apps/train.py).

    python -m icon_tpu_torch.apps.train -cfg <yaml> [key value ...]
    python -m icon_tpu_torch.apps.train -cfg <yaml> -resume
    python -m icon_tpu_torch.apps.train -cfg <yaml> -test

Training reads ``PIFuDataset`` through a ``DataLoader`` with
``cfg.num_threads`` worker processes, takes optax's steps
(``training/train_step.py``) on one device, validates each epoch and keeps
the top 3 checkpoints by validation loss plus the latest; ``-resume``
restores the parameters, BatchNorm statistics, optimizer state and step.
Prediction panels (the sampled points coloured by error and an occupancy
slice) go to ``<ckpt_dir>/<name>/images`` every ``freq_show_train`` of an
epoch. ``-test`` runs the benchmark evaluation (``eval/test_loop.py``) on
the test split with the best or latest checkpoint.

Data parallel (the reference's Lightning DDP with sync_batchnorm,
apps/train.py:117-121): ``num_devices`` > 1 starts
``make_mesh_for_batch``'s count of ranks on this host, one a card (CPU
ranks when the caller asks for the CPU), in spawned processes joined in a
``finally``; ``-dist`` joins the group the environment describes
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``; see
``parallel/dist.py``), and without one runs a single process, as the JAX
trainer does. Each rank loads its contiguous slice of every global batch,
BatchNorm takes the global moments and the gradients are averaged over
the ranks each step; rank 0 alone writes checkpoints, logs, panels and the
config snapshot, and ``-resume`` reads after a barrier, so every rank
restores the same step. ``-test`` point-shards the recon over
``num_devices`` devices instead (``eval/test_loop.py``).

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
    ap = argparse.ArgumentParser(prog="icon_tpu_torch.apps.train")
    ap.add_argument("-cfg", "--config_file", required=True)
    ap.add_argument("-test", "--test_mode", action="store_true")
    ap.add_argument("-resume", action="store_true",
                    help="full resume from the latest checkpoint")
    ap.add_argument("--max_steps", type=int, default=0,
                    help="stop after this many steps in all")
    ap.add_argument("--max_eval_items", type=int, default=0)
    ap.add_argument("-dist", "--distributed", action="store_true",
                    help="multi-process: join the group of "
                    "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return ap.parse_args(argv)


def _needs_normal_net(dataset) -> bool:
    """Whether the NormalNet must predict the normal maps: the dataset has
    no ``normal_F``/``normal_B`` renders."""
    if not len(dataset):
        return True
    folder = dataset._paths(dataset.subjects[0],
                            dataset.rotations[0])["folder"]
    return not all(osp.isdir(osp.join(folder, n))
                   for n in ("normal_F", "normal_B"))


def build_model(cfg, dataset, device) -> torch.nn.Module:
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    torch.manual_seed(0)
    return HGPIFuNet(cfg, normal_net=_needs_normal_net(dataset)).to(device)


def prediction_panels(model, batch: Dict) -> Dict[str, np.ndarray]:
    """The first item's inputs, its sample points coloured by error
    against their labels, and an occupancy slice through the origin."""
    from icon_tpu_torch.data.datasets import SHARED_KEYS
    from icon_tpu_torch.ops.projection import project
    from icon_tpu_torch.training.visuals import (occupancy_slice_image,
                                                 point_error_image)
    one = {k: (v if k in SHARED_KEYS else v[:1]) for k, v in batch.items()
           if torch.is_tensor(v)}
    was_training = model.training
    model.eval()
    with torch.no_grad():
        pred, _ = model(one)
    model.train(was_training)
    xyz = project(one["sample"], one["calib"])
    panels = {k: one[k][0].cpu().numpy() for k in
              ("image", "normal_F", "T_normal_F") if k in one}
    panels["pred_vs_label"] = point_error_image(
        xyz[0, :, :2].cpu().numpy(), pred[0].cpu().numpy(),
        one["label"][0].cpu().numpy(), size=one["image"].shape[1])
    panels["occ_slice_z"] = occupancy_slice_image(model, one, res=65)
    return panels


def run_test(cfg, args, device) -> dict:
    """Benchmark evaluation (reference apps/train.py:100-110)."""
    from icon_tpu_torch.data.datasets import PIFuDataset
    from icon_tpu_torch.eval.test_loop import run_evaluation
    from icon_tpu_torch.training.checkpoints import (CheckpointManager,
                                                     load_checkpoint,
                                                     partial_warm_start)
    np.random.seed(1993)
    dataset = PIFuDataset(cfg, split="test")
    if len(dataset) == 0:
        raise SystemExit(f"no test data under {cfg.dataset.root!r}")
    model = build_model(cfg, dataset, device)
    mgr = CheckpointManager(osp.join(cfg.ckpt_dir, cfg.name))
    path = cfg.resume_path or mgr.best or mgr.latest
    if path and osp.exists(path):
        # parameters and the BatchNorm statistics of training
        model.load_state_dict(partial_warm_start(
            model.state_dict(), load_checkpoint(path)["state_dict"]))
        print(f"[test] loaded {path}")
    records: List[dict] = []
    table = run_evaluation(cfg, dataset, model,
                           max_items=args.max_eval_items, device=device,
                           records=records,
                           num_devices=cfg.num_devices or 1)
    return {"table": table, "items": records, "ckpt": path}


def run_train(cfg, args, device) -> dict:
    from icon_tpu_torch.config import save_config
    from icon_tpu_torch.data.datasets import (PIFuDataset, close_iter,
                                              make_loader)
    from icon_tpu_torch.training.checkpoints import (CheckpointManager,
                                                     load_checkpoint,
                                                     partial_warm_start,
                                                     restore)
    from icon_tpu_torch.training.logging import MetricLogger
    from icon_tpu_torch.training.train_step import (batch_to, eval_step,
                                                    make_optimizer,
                                                    train_step)

    dataset = PIFuDataset(cfg, split="train")
    if len(dataset) == 0:
        raise SystemExit(
            f"no training data found under {cfg.dataset.root!r} — see "
            "docs/dataset.md of the reference for the expected layout")
    main_rank = dist.is_main_process()
    shard = {"process_index": dist.rank(), "process_count": dist.world()}
    loader = make_loader(dataset, batch_size=cfg.batch_size,
                         num_workers=cfg.num_threads, **shard)
    val_dataset = PIFuDataset(cfg, split="val")
    if len(val_dataset) == 0:
        val_dataset = PIFuDataset(cfg, split="test")
    val_loader = make_loader(val_dataset, batch_size=cfg.batch_size,
                             shuffle=False, num_workers=cfg.num_threads,
                             drop_last=False, pad_last=True, **shard) \
        if len(val_dataset) else None
    steps_per_epoch = len(loader)

    model = build_model(cfg, dataset, device)
    opt = make_optimizer(model, cfg, steps_per_epoch)
    ckpt_dir = osp.join(cfg.ckpt_dir, cfg.name)
    dist.barrier()                # -resume: every rank reads one index
    mgr = CheckpointManager(ckpt_dir, top_k=3)
    step = 0
    if args.resume and mgr.latest and osp.exists(mgr.latest):
        step = restore(model, opt, mgr.latest)
        print(f"[train] resumed from {mgr.latest} at step {step}")
    else:
        # partial warm starts (reference train.py:177-229)
        for path, rename in ((cfg.resume_path, None),
                             (cfg.normal_path, {"netG": "normal_filter"})):
            if path and osp.exists(path):
                model.load_state_dict(partial_warm_start(
                    model.state_dict(), load_checkpoint(path)["state_dict"],
                    rename))
    logger = MetricLogger(ckpt_dir, enabled=main_rank)
    if main_rank and not osp.exists(osp.join(ckpt_dir, "cfg.yaml")):
        save_config(cfg, osp.join(ckpt_dir, "cfg.yaml"))
    show_every = max(int(cfg.freq_show_train * steps_per_epoch), 1)

    record = {"start_step": step, "losses": [], "step_s": [], "wait_s": [],
              "val_loss": [], "ckpts": [], "panels": []}
    iters = []
    t0 = time.perf_counter()
    try:
        for epoch in range(step // max(steps_per_epoch, 1), cfg.num_epoch):
            loader.set_epoch(epoch)
            iters.append(iter(loader))
            t_wait = time.perf_counter()
            for batch in iters[-1]:
                t_step = time.perf_counter()
                metrics = train_step(model, opt, batch_to(batch, device))
                m = {k: float(v) for k, v in metrics.items()}
                step += 1
                record["wait_s"].append(t_step - t_wait)
                record["step_s"].append(time.perf_counter() - t_step)
                record["losses"].append(m["loss"])
                logger.log(step, m)
                if step % 20 == 0:
                    print(f"epoch {epoch} step {step}: {m}", flush=True)
                if main_rank and step % show_every == 0:
                    try:
                        record["panels"].append(logger.log_images(
                            step, prediction_panels(
                                model, batch_to(batch, device))))
                    except Exception as e:  # a panel never ends a run
                        print(f"[train] prediction panel failed: {e}")
                if args.max_steps and step >= args.max_steps:
                    break
                t_wait = time.perf_counter()
            close_iter(iters[-1])
            # validation epoch -> top-k checkpointing on the val loss
            val_loss = float("nan")
            if val_loader is not None:
                iters.append(iter(val_loader))
                vals = [float(eval_step(model, batch_to(vb, device))["loss"])
                        for vb in iters[-1]]
                val_loss = float(np.mean(vals)) if vals else float("nan")
                logger.log(step, {"val_loss": val_loss})
                print(f"epoch {epoch}: val_loss={val_loss:.4f}", flush=True)
            record["val_loss"].append(val_loss)
            if main_rank:
                record["ckpts"].append(mgr.save(
                    step, model, opt,
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
    print(f"done: {step} steps in {record['seconds']:.0f}s")
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
    CPU); returns the run's record, rank 0's when several ranks train
    (training: the step count, the loss per step, each step's seconds and
    the wait for its batch, the validation losses, the checkpoints and
    panels written, the rank count; ``-test``: the benchmark table and each
    item's metrics). ``timeout``: the seconds the spawned ranks of a
    ``num_devices`` run may take before they are killed (None: no limit)."""
    import sys
    from icon_tpu_torch.config import load_config
    from icon_tpu_torch.parallel.mesh import make_mesh_for_batch
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    cfg = load_config(args.config_file, overrides=args.opts or None)
    device = torch.device(device)
    if args.distributed and dist.initialize_distributed(device=device):
        device = dist.rank_device(device, dist.rank())
        print(f"[dist] rank {dist.rank()}/{dist.world()} on {device}, "
              f"backend {torch.distributed.get_backend()}", flush=True)
        try:
            return (run_test if args.test_mode else run_train)(cfg, args,
                                                               device)
        finally:
            dist.shutdown()
    if args.test_mode:
        return run_test(cfg, args, device)
    if (cfg.num_devices or 1) > 1:
        mesh = make_mesh_for_batch(cfg.batch_size, cfg.num_devices, device)
        if len(mesh) > 1:
            print(f"[train] {len(mesh)} ranks on {mesh}", flush=True)
            return dist.run_on_mesh(_run_rank, mesh, (argv,),
                                    timeout=timeout)
    return run_train(cfg, args, device)


if __name__ == "__main__":
    main()
