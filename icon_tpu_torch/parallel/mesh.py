"""Device meshes and sharding helpers (``icon_tpu.parallel.mesh``) in
PyTorch's idiom: a mesh is a list of ``torch.device``.

A mesh of cards serves point-parallel recon (:func:`shard_query`); data
parallel training runs one process a card (``parallel/dist.py``), where
:func:`shard_batch` gives a rank its contiguous slice of the global batch.
On the CPU, ``n`` CPU shards stand in for ``n`` devices, as XLA's virtual
CPU devices do for the JAX package's tests.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

Mesh = List[torch.device]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The first ``n_devices`` cards (all of them when None), or, with
    ``device`` on the CPU, ``n_devices`` CPU shards (default 1). Too few
    cards raise the JAX CLI's error."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    avail = torch.cuda.device_count()
    n = n_devices or avail
    if avail < n:
        raise SystemExit(f"-num_devices {n} but only {avail} devices "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh_for_batch(batch_size: int, n_devices: Optional[int] = None,
                        device="cuda") -> Mesh:
    """A mesh whose size divides the batch: the largest such count up to
    ``n_devices`` (default: every card; 1 on the CPU)."""
    if n_devices:
        avail = n_devices
    elif torch.device(device).type == "cpu":
        avail = 1
    else:
        avail = torch.cuda.device_count()
    d = max(g for g in range(1, avail + 1) if batch_size % g == 0)
    return make_mesh(d, device)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def to_device(tree: Any, device) -> Any:
    """The tensors of ``tree`` (dicts, lists, tuples) on ``device`` (the
    same tensors where they already lie there)."""
    return _tree_map(lambda t: t.to(device), tree)


def shard_batch(batch: Dict[str, Any], rank: int, world: int,
                shared_keys: Optional[Sequence[str]] = None
                ) -> Dict[str, Any]:
    """Rank ``rank``'s contiguous ``B / world`` slice of every tensor and
    list of a global batch; the ``shared_keys`` (default: the loader's
    ``SHARED_KEYS``) stay whole."""
    if shared_keys is None:
        from icon_tpu_torch.data.datasets import SHARED_KEYS
        shared_keys = SHARED_KEYS

    def part(v):
        b = len(v)
        if b % world:
            raise ValueError(f"batch {b} does not split over {world} ranks")
        lb = b // world
        return v[rank * lb:(rank + 1) * lb]
    return {k: v if k in shared_keys or not (torch.is_tensor(v) or
                                             isinstance(v, list))
            else part(v) for k, v in batch.items()}


def shard_points(points: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``points [B, N, ...]`` split along N into one contiguous slice a
    device, each on its device; N must divide by the mesh size."""
    n = len(mesh)
    if points.shape[1] % n:
        raise ValueError(f"point count {points.shape[1]} not divisible by "
                         f"mesh {n}")
    return [p.to(d) for d, p in zip(mesh, points.chunk(n, dim=1))]


class Replicas:
    """``module`` on any device, copied there on first use (the module
    itself on its own device): ``replicas(pts.device)`` inside a query lets
    each shard of :func:`shard_query` run the network on its device."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self._on = {next(module.parameters()).device: module}

    def __call__(self, device: torch.device) -> torch.nn.Module:
        if device not in self._on:
            self._on[device] = copy.deepcopy(self.module).to(device)
        return self._on[device]


GROUP_NORM_WARNING = (
    "WARNING: norm_mlp=group normalizes over the point axis — sharded "
    "stats differ from single-device (published ckpts use norm_mlp=batch, "
    "which is shard-exact; see parallel.mesh.shard_query)")


def shard_query(query_fn: Callable, mesh: Mesh) -> Callable:
    """Point-parallel occupancy queries: ``wrapped(pts [1, N, 3], *args)``
    splits N into ``len(mesh)`` equal contiguous slices, queries slice i
    on ``mesh[i]`` with ``args`` (tensors, dicts and tuples of them) moved
    there, and concatenates the ``[1, N/d, 1]`` results on ``mesh[0]``.
    ``query_fn`` must compute on the device of its points (a network
    through :class:`Replicas`). Pass the wrapped function to
    ``ReconEngine(..., pad_multiple=len(mesh))`` so every level's points
    divide evenly; N must divide by the mesh size.

    Per-point math is the same in every slice, so sharded equals unsharded
    up to the ULP of products that tile differently. A ``norm_mlp: group``
    MLP normalizes over the point axis, so its statistics change with the
    slice: the CLIs that shard print :data:`GROUP_NORM_WARNING` for it, as
    the JAX CLI does."""
    n = len(mesh)

    def wrapped(pts: torch.Tensor, *args):
        assert pts.shape[1] % n == 0, \
            f"point count {pts.shape[1]} not divisible by mesh {n}"
        outs = [query_fn(part, *to_device(args, d))
                for d, part in zip(mesh, shard_points(pts, mesh))]
        return torch.cat([o.to(mesh[0]) for o in outs], dim=1)

    return wrapped
