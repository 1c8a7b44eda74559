"""Rank functions for the multi-process tests (tests/test_torch_dist*.py).

Each runs in a spawned process under ``dist.run_on_mesh`` as
``fn(*args, device=...)`` in a gloo group of CPU ranks. This module imports
torch and the port only (no JAX), so a rank starts in a few seconds.
Every function returns what all ranks computed, gathered on rank 0.
"""

import os
import threading
import time

import torch
import torch.distributed as tdist


RANK_TIMEOUT = 120.0


class Ranks:
    """``dist.run_on_mesh(fn, [cpu, cpu], args)`` in a thread, so that the
    test's process works meanwhile; ``result()`` joins it (the ranks
    themselves within ``RANK_TIMEOUT``) and checks that no child is
    left."""

    def __init__(self, fn, args):
        from icon_tpu_torch.parallel import dist
        self.out, self.error = None, None

        def run():
            try:
                self.out = dist.run_on_mesh(fn, [torch.device("cpu")] * 2,
                                            args, timeout=RANK_TIMEOUT)
            except BaseException as e:      # noqa: BLE001 - raised below
                self.error = e
        self.thread = threading.Thread(target=run)
        self.thread.start()

    def result(self):
        self.thread.join(RANK_TIMEOUT + 60.0)
        assert not self.thread.is_alive(), "the ranks did not end"
        if self.error is not None:
            raise self.error
        assert children() == []
        return self.out


def gather(obj):
    """``obj`` of every rank, in rank order."""
    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, obj)
    return out


def children() -> list:
    """This process's live child processes (from /proc)."""
    me = str(os.getpid())
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me and fields[0] != "Z":
            out.append(int(name))
    return out


def bn_moments(xs, device):
    """Each BatchNorm{1,2,3}d (momentum 1: the running statistics are the
    batch's moments) on this rank's contiguous slice of the global batch
    ``xs[d]``; this rank's ``shard_batch`` slice of a batch with a shared
    key and a list; a module whose parameter has no gradient on any rank
    through ``all_reduce_mean_grads``."""
    from icon_tpu_torch.models.layers import (BatchNorm1d, BatchNorm2d,
                                              BatchNorm3d)
    from icon_tpu_torch.parallel import dist
    from icon_tpu_torch.parallel.mesh import shard_batch
    r, n = dist.rank(), dist.world()
    out = {}
    for d, cls in ((1, BatchNorm1d), (2, BatchNorm2d), (3, BatchNorm3d)):
        x = shard_batch({"x": torch.from_numpy(xs[d])}, r, n)["x"]
        bn = cls(x.shape[1], momentum=1.0).train()
        y = bn(x.clone().requires_grad_(True))
        # each element weighted by its index in the global batch, so the
        # ranks' losses sum to the global batch's
        at = torch.arange(y.numel()) + r * y.numel()
        (y * y * at.reshape(y.shape)).sum().backward()
        nbytes = dist.all_reduce_mean_grads(bn)
        out[d] = {"mean": bn.running_mean.numpy(),
                  "var": bn.running_var.numpy(),
                  "y": y.detach().numpy(),
                  "weight_grad": bn.weight.grad.numpy(), "bytes": nbytes}
    part = shard_batch({"x": torch.from_numpy(xs[2]), "names": list("abcd"),
                        "smpl_faces": torch.arange(6)}, r, n)
    out["slice"] = {k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in part.items()}
    lin = torch.nn.Linear(2, 2)
    lin.bias.requires_grad_(True)
    lin(torch.ones(1, 2)).sum().backward()
    lin.bias.grad = None                 # no gradient on any rank
    dist.all_reduce_mean_grads(lin)
    out["none_stays"] = lin.bias.grad is None
    return gather(out)


def _rank_slice(batch, shared=("smpl_faces", "smpl_vf_table",
                               "voxel_codes", "voxel_faces")):
    from icon_tpu_torch.parallel import dist
    from icon_tpu_torch.parallel.mesh import shard_batch
    return shard_batch(batch, dist.rank(), dist.world(), shared)


def train_steps(path, steps, device):
    """``steps`` of ``train_step`` from the saved state (``path``: the
    port's config, the net's state dict, the optimizer's state, the global
    batch), each rank on its slice: the losses, the state dict after."""
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.training.train_step import make_optimizer, train_step
    saved = torch.load(path, weights_only=False)
    cfg = saved["cfg"]
    net = HGPIFuNet(cfg, normal_net=False)
    net.load_state_dict(saved["state"])
    opt = make_optimizer(net, cfg, steps_per_epoch=saved["steps_per_epoch"])
    opt.load_state_dict(saved["opt"])
    batch = _rank_slice(saved["batch"])
    losses = [float(train_step(net, opt, batch)["loss"])
              for _ in range(steps)]
    return gather({"losses": losses,
                   "state": {k: v.numpy() for k, v in
                             net.state_dict().items()}})


def normal_steps(path, steps, device):
    """``steps`` of ``normal_train_step`` from the saved NormalNet state
    (``path``: the config, the state dict, the global batch), each rank on
    its slice: the losses, the state dict after."""
    from icon_tpu_torch.apps.train_normal import build_normal_net
    from icon_tpu_torch.training.normal_step import (make_normal_optimizer,
                                                     normal_train_step)
    saved = torch.load(path, weights_only=False)
    net = build_normal_net(saved["cfg"], device)
    net.load_state_dict(saved["state"])
    opt = make_normal_optimizer(net, saved["cfg"])
    batch = _rank_slice(saved["batch"])
    losses = [float(normal_train_step(net, opt, batch)["loss"])
              for _ in range(steps)]
    return gather({"losses": losses,
                   "state": {k: v.numpy() for k, v in
                             net.state_dict().items()}})


def hang(device):
    """A rank that never returns."""
    time.sleep(3600)
