"""Multi-process runtime on ``torch.distributed`` (``icon_tpu.parallel.dist``;
reference: Lightning spawning one rank a GPU over NCCL, apps/train.py:
117-121).

One process a rank, one card a rank. Configuration follows the JAX
package's launcher conventions: explicit arguments win, then the
environment, then the single-process default.

  COORDINATOR_ADDRESS   host:port of rank 0's store (e.g. "10.0.0.2:8476")
  NUM_PROCESSES         world size
  PROCESS_ID            this process's rank

The backend is NCCL when every rank has a card of its own, gloo on the CPU.
NCCL refuses two ranks on one card, so such a placement must ask for gloo
by name (``backend="gloo"``); without it,
:func:`initialize_distributed` raises before the group exists. Nothing
falls back quietly.

The collectives the port uses: :func:`all_reduce_mean_grads` (one
flattened all-reduce of the gradients a step), :func:`all_reduce_sum`
(differentiable: BatchNorm's global moments) and :func:`barrier`.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=5)   # the store's and collectives'
GRACE_S = 10.0          # a rank's time to exit before it is killed


def distributed_env(environ=None):
    """The coordinator config of the environment: a dict with
    coordinator_address, num_processes and process_id, or None when the
    environment does not describe a multi-process run."""
    env = environ if environ is not None else os.environ
    addr = env.get("COORDINATOR_ADDRESS")
    n = env.get("NUM_PROCESSES")
    pid = env.get("PROCESS_ID")
    if not addr and not n:
        return None
    return {
        "coordinator_address": addr,
        "num_processes": int(n) if n else 1,
        "process_id": int(pid) if pid else 0,
    }


def rank_device(device, rank: int) -> torch.device:
    """The card of ``rank`` (``cuda:{rank % cards}``) when ``device`` is
    ``cuda`` without an index; ``device`` itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return device


def _check_placement(store, rank: int, world_size: int,
                     device: torch.device):
    """Raise on every rank when two ranks of an NCCL group share a card.
    Each rank writes its (host, card) to the store and reads all of them;
    rank 0, whose process holds the store, waits until every rank has read
    before it goes on or raises."""
    me = f"{socket.gethostname()}/{device}"
    store.set(f"placement/{rank}", me)
    seen = [store.get(f"placement/{r}").decode() for r in range(world_size)]
    store.add("placement/read", 1)
    if rank == 0:
        deadline = time.monotonic() + TIMEOUT.total_seconds()
        while store.add("placement/read", 0) < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError("ranks did not report their placement")
            time.sleep(0.01)
    shared = [r for r, p in enumerate(seen) if p == me]
    if len(shared) > 1:
        raise ValueError(
            f"ranks {shared} share {me}: NCCL refuses two ranks on one "
            "card; ask for backend='gloo' to place them there")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           environ=None, backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group: rank ``process_id`` of ``num_processes``,
    whose rank 0 serves the store at ``coordinator_address``, the rank's
    collectives on ``device`` (default: its card, :func:`rank_device`).

    Returns False, doing nothing, for a single process (no environment,
    ``num_processes`` <= 1) and True when a group exists after the call,
    also when it existed before (the JAX function's return values). The
    backend is ``backend``, else NCCL on a card and gloo on the CPU; NCCL
    with two ranks on one card raises."""
    if dist.is_initialized():
        return True
    cfg = {"coordinator_address": coordinator_address,
           "num_processes": num_processes, "process_id": process_id}
    if cfg["num_processes"] is None:
        envcfg = distributed_env(environ)
        if envcfg is None:
            return False
        for k, v in envcfg.items():
            if cfg[k] is None:
                cfg[k] = v
    world_size = cfg["num_processes"] or 1
    if world_size <= 1:
        return False
    rank = cfg["process_id"] or 0
    if not cfg["coordinator_address"]:
        raise ValueError(f"{world_size} processes need a coordinator "
                         "address (COORDINATOR_ADDRESS=host:port)")
    device = rank_device("cuda" if device is None else device, rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a card, the rank is on {device}")
    host, port = cfg["coordinator_address"].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world_size, is_master=rank == 0,
                          timeout=TIMEOUT)
    if backend == "nccl":
        _check_placement(store, rank, world_size, device)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, which alone writes checkpoints, logs and panels (reference
    rank-zero-only checkpointing, apps/train.py:47-61)."""
    return rank() == 0


def barrier() -> None:
    if world() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous().clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (identity without a
    group of several)."""
    return _AllReduceSum.apply(x) if world() > 1 else x


def all_reduce_mean_grads(model: torch.nn.Module) -> int:
    """Replace each trainable parameter's gradient by its mean over the
    ranks, in one flattened all-reduce; a gradient that is None on every
    rank stays None (one that is None on some ranks counts as zeros there).
    Returns the bytes reduced (0 without a group of several)."""
    n = world()
    params = [p for p in model.parameters() if p.requires_grad]
    if n <= 1 or not params:
        return 0
    grads = [p.grad.reshape(-1) if p.grad is not None
             else p.new_zeros(p.numel()) for p in params]
    have = torch.tensor([float(p.grad is not None) for p in params],
                        dtype=grads[0].dtype, device=grads[0].device)
    flat = torch.cat(grads + [have])
    dist.all_reduce(flat)
    flat /= n
    present = [p.grad is not None for p in params]
    if not all(present):        # one host read, only where one is missing
        present = (flat[-len(params):] > 0).tolist()
    off = 0
    for p, g, ok in zip(params, grads, present):
        if ok:
            mean = flat[off:off + g.numel()].view_as(p)
            if p.grad is None:
                p.grad = mean.clone()
            else:
                p.grad.copy_(mean)
        off += g.numel()
    return flat.numel() * flat.element_size()


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, nprocs: int, args: tuple = (),
              timeout: Optional[float] = None) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes (``fn`` must be
    importable: a module-level function). Waits for all of them, at most
    ``timeout`` seconds when given (then TimeoutError); a rank that fails
    ends the others and its error is raised here. In a ``finally`` every
    rank still running is terminated, killed after ``GRACE_S`` seconds,
    every rank is joined, and the resource tracker that spawning starts is
    stopped when this call started it, so no child outlives the call."""
    import gc
    import torch.multiprocessing as mp
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    had_tracker = tracker._pid is not None
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0, grace_period=GRACE_S):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
    finally:
        alive = [p for p in ctx.processes if p.is_alive()]
        for p in alive:
            p.terminate()
        end = time.monotonic() + GRACE_S
        for p in alive:
            p.join(max(end - time.monotonic(), 0.0))
            if p.is_alive():       # stuck in a collective: SIGTERM unheard
                p.kill()
        for p in ctx.processes:
            p.join()
        del ctx
        gc.collect()
        if not had_tracker and tracker._pid is not None:
            tracker._stop()


def _mesh_rank(rank: int, fn, mesh, port: int, args: tuple, out: str,
               threads: int) -> None:
    device = mesh[rank]
    if device.type == "cpu":
        torch.set_num_threads(threads)
    initialize_distributed(f"127.0.0.1:{port}", len(mesh), rank,
                           device=device)
    try:
        result = fn(*args, device=device)
        if rank == 0:
            torch.save(result, out)
    finally:
        shutdown()


def run_on_mesh(fn, mesh, args: tuple = (),
                timeout: Optional[float] = None):
    """``fn(*args, device=mesh[i])`` on rank i of ``len(mesh)`` spawned
    processes in one group on this host (NCCL when each rank has its own
    card, gloo on the CPU; :func:`run_ranks` joins them); returns rank 0's
    result. ``fn`` must be a module-level function. CPU ranks share this
    process's intra-op threads (more threads than cores makes each of them
    wait on the others' spinning threads, many times slower)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.pt")
        run_ranks(_mesh_rank, len(mesh),
                  (fn, list(mesh), free_port(), args, out,
                   max(1, torch.get_num_threads() // len(mesh))),
                  timeout=timeout)
        return torch.load(out, weights_only=False)
