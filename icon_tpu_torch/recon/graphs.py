"""CUDA graphs of the serving frames: a call captured once, then replayed.

The JAX package runs each engine level and the filter as one cached XLA
executable (``icon_tpu/recon/engine.py:__call__`` with ``jit_levels``,
``bench.py``'s ``filter_jit``); here the counterpart is a CUDA graph, which
replays a level's launches in one ``cudaGraphLaunch`` instead of
dispatching each torch operation from Python.

:class:`GraphedCall` captures ``fn(*inputs)`` at its first call and
replays it at every later one. The tensors of the capturing call are the
graph's input buffers: a later call's tensor whose ``data_ptr`` differs
from the captured one is copied into that buffer on the device first (a
graph's own output passed back in, as the filter's features, needs no
copy). The outputs are the graph's buffers, overwritten by its next
replay; work already enqueued on them is safe by stream order, and a
caller that keeps one past the next replay clones it. Before the capture
``fn`` runs once eagerly on a side stream, so that every library is loaded
and bound, cuDNN has chosen its algorithms and every constant is on the
card. A failed capture raises: nothing falls back to eager dispatch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree


class StaticInputs:
    """A pytree of tensors (and other leaves, compared by equality) that
    later trees of the same structure are copied into."""

    def __init__(self, tree):
        self.leaves, self.spec = pytree.tree_flatten(tree)
        self.tree = tree

    def load(self, tree):
        """The held tree, with each tensor leaf of ``tree`` copied into its
        buffer on the device where their ``data_ptr``s differ."""
        leaves, spec = pytree.tree_flatten(tree)
        if spec != self.spec:
            raise ValueError(f"the inputs' structure changed since the "
                             f"capture: {spec} vs {self.spec}")
        for cur, held in zip(leaves, self.leaves):
            if not torch.is_tensor(held):
                if torch.is_tensor(cur) or cur != held:
                    raise ValueError(f"a non-tensor input changed since the "
                                     f"capture: {cur!r} vs {held!r}")
                continue
            if not torch.is_tensor(cur) or cur.shape != held.shape or \
                    cur.dtype != held.dtype or cur.device != held.device:
                raise ValueError(
                    f"a tensor input changed shape, type or device since the "
                    f"capture: {getattr(cur, 'shape', cur)} vs "
                    f"{tuple(held.shape)} {held.dtype} {held.device}")
            if cur is held or (cur.data_ptr() == held.data_ptr() and
                               cur.stride() == held.stride()):
                continue
            held.copy_(cur)
        return self.tree


class GraphedCall:
    """``fn(*inputs)`` captured as a CUDA graph on its first call and
    replayed at every later one (module docstring). ``pool``: a
    ``torch.cuda.graph_pool_handle()`` shared with other graphs that never
    replay concurrently, or None for a pool of its own."""

    def __init__(self, fn: Callable, pool=None):
        self.fn = fn
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Optional[StaticInputs] = None
        self.outputs = None
        self.replays = 0

    def __call__(self, *inputs):
        if self.graph is None:
            self._capture(inputs)
        else:
            self.inputs.load(inputs)
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def _capture(self, inputs) -> None:
        leaves = [t for t in pytree.tree_leaves(inputs) if torch.is_tensor(t)]
        if any(t.device.type != "cuda" for t in leaves):
            raise ValueError("a CUDA graph takes CUDA tensors only")
        self.inputs = StaticInputs(inputs)
        args = self.inputs.tree
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*args)                    # warm-up: binds, plans, loads
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.pool is None:
            with torch.cuda.graph(graph):
                self.outputs = self.fn(*args)
        else:
            with torch.cuda.graph(graph, pool=self.pool):
                self.outputs = self.fn(*args)
        self.graph = graph
