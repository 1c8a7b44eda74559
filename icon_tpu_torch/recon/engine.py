"""Coarse-to-fine occupancy reconstruction engine
(``icon_tpu.recon.engine``; reference ``Seg3dLossless``,
lib/common/seg3d_lossless.py:152-471).

Resolutions 33 -> 65 -> 129 -> ... -> (mcube_res + 1): dense evaluation at
the coarsest level, then per level a trilinear align_corners upsample of the
occupancy and of the >0.5 indicator; boundary voxels are where the indicator
lies strictly between 0 and 1, dilated by a box filter (9/7/3 by level),
minus the voxels already evaluated. They are compacted into a fixed
per-level point budget (first ``budget`` in linear order) and evaluated. In
faster mode the last level is interpolation only; ``faster=False``
evaluates it too. The budget overflow is reported per level. With
``virtual_final`` faster mode stops before the last upsample and returns
the grid below it, for a marcher of its virtual upsample.

Exact mode adds the reference's conflict resolution (seg3d_lossless.py:
388-471) in ``conflict_rounds`` static rounds a level: where a fresh value
and the interpolation it replaces lie on opposite sides of the balance, the
clamped 3^3 neighbourhood not yet evaluated is evaluated too; the flips
left in the last round's points are reported as the residual.

``pad_multiple`` rounds every point buffer (budgets, the auto-budget
ladder, level 0) up to a multiple of a mesh's size, so that
``parallel.mesh.shard_query`` splits each level evenly. The counts stay
0-d device tensors: nothing inside a level reads the device.

A frame never waits for the card (the JAX engine's lazy counts,
``icon_tpu/recon/engine.py:147-197``, on CUDA events): with
``auto_budget`` each level's boundary count starts its copy to pinned host
memory as soon as it is enqueued (:class:`HostCopy`), and the next frame
takes it only once that copy has landed, reusing the last bucket until
then; only the first count of a level is waited for. Constants come from
``ops/constants.py``, never from a copy out of pageable memory.

The world box is b_min=(-1, 1, -1), b_max=(1, -1, 1) (y flipped), as in the
reference's apps/ICON.py:78-90.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from icon_tpu_torch.kernels import level as lk
from icon_tpu_torch.kernels.level import B_MAX, B_MIN, BALANCE  # noqa: F401
from icon_tpu_torch.kernels.level import compact_plain as _compact  # noqa
from icon_tpu_torch.kernels.level import grid_to_world as _grid_to_world
from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.recon.graphs import GraphedCall, StaticInputs

# the 27 offsets (dz, dy, dx) of a voxel's 3^3 neighbourhood
_NEIGHBOURS = np.array([(dz, dy, dx) for dz in (-1, 0, 1)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def reconstruction_resolutions(mcube_res: int) -> Tuple[int, ...]:
    """Reference resolution ladder (apps/ICON.py:62-73): logspace powers of
    two from 32 to mcube_res, plus one (odd for align_corners)."""
    n = int(np.log2(mcube_res) - 4)
    res = np.logspace(5, np.log2(mcube_res), base=2, num=n, endpoint=True)
    return tuple(int(r) + 1 for r in res)


def default_budgets(resolutions: Sequence[int]) -> Tuple[int, ...]:
    """Per-level re-evaluation caps (levels 1..n-1; faster mode never uses
    the last): (18, 14, 7) * r^2 for the (9, 7, 3) dilation kernels, sized
    for a clothed human's boundary area with headroom."""
    out = []
    for lv, r in enumerate(resolutions[1:], start=1):
        k = 9 if lv == 1 else (7 if lv == 2 else 3)
        mult = {9: 18, 7: 14, 3: 7}[k]
        out.append(min(r ** 3, mult * r * r))
    return tuple(out)


def _check_ladder(occ: torch.Tensor, r: int) -> None:
    """The level kernels take the r -> 2r - 1 ladder only."""
    if r != 2 * occ.shape[0] - 1:
        raise ValueError(f"level {r} is not the 2x upsample of "
                         f"{occ.shape[0]}")


class HostCopy:
    """A tensor's copy to the host, started when this is made. On a CUDA
    device it goes into pinned memory with ``non_blocking=True`` and an
    event is recorded on the tensor's current stream after it, so making
    it never waits for the card; on the CPU the tensor itself stands for
    the copy, which has always landed and pins nothing."""

    def __init__(self, value: torch.Tensor):
        if value.device.type == "cuda":
            self.host = torch.empty(value.shape, dtype=value.dtype,
                                    pin_memory=True)
            self.host.copy_(value, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(value.device))
        elif value.device.type == "cpu":
            self.host, self.event = value, None
        else:
            raise ValueError(f"unsupported device {value.device}")

    def ready(self) -> bool:
        """Whether the copy has landed; never waits."""
        return self.event is None or self.event.query()

    def wait(self) -> torch.Tensor:
        """The host tensor, once the copy has landed (waits for it)."""
        if not self.ready():
            self.event.synchronize()
        return self.host


class ReconEngine:
    """Occupancy-field evaluator: ``query_fn(points [1, N, 3], *query_args)
    -> [1, N, 1]``."""

    def __init__(self, resolutions: Sequence[int],
                 budgets: Optional[Sequence[int]] = None,
                 faster: bool = True, exact: bool = False,
                 conflict_rounds: int = 2, pad_multiple: int = 1,
                 auto_budget: bool = False,
                 auto_headroom: float = 1.5, virtual_final: bool = False,
                 device="cuda"):
        """``faster``: the last level is interpolation only. ``exact``:
        conflict resolution in ``conflict_rounds`` rounds a level, every
        level evaluated (it implies ``faster=False``). ``pad_multiple``:
        every point buffer a multiple of it (a mesh's size for sharded
        queries). ``auto_budget``: each frame sizes its per-level point
        buffers from the previous frame's boundary count x
        ``auto_headroom``, snapped to a geometric bucket ladder; the first
        frame and any frame after an overflow use the caps (``budgets``).
        ``virtual_final`` (faster mode only): stop before the final
        upsample and return the grid below it, for a marcher of its virtual
        2x upsample (``recon/marching.py:marching_lattice_virtual``,
        ``AutoMarcher(virtual=True)``), so the final grid is never written:
        a memory option for high final resolutions. Grids and query points
        live on ``device``: the card unless the caller asks for the CPU."""
        self.device = torch.device(device)
        self.resolutions = tuple(resolutions)
        for r in self.resolutions:
            if r % 2 != 1:
                raise ValueError(f"resolutions must be odd (align_corners), "
                                 f"got {self.resolutions}")
        budgets = tuple(budgets) if budgets is not None \
            else default_budgets(self.resolutions)
        self.pad_multiple = m = max(pad_multiple, 1)
        self.budgets = tuple(-(-b // m) * m for b in budgets)
        self.faster = faster and not exact
        self.exact = exact
        self.conflict_rounds = conflict_rounds
        self.auto_budget = auto_budget
        self.auto_headroom = auto_headroom
        self.virtual_final = virtual_final and self.faster
        self._last_counts: Dict[int, HostCopy] = {}
        self._last_hosts: Dict[int, int] = {}
        self._bucket_used: Dict[int, int] = {}
        # graph_levels: {(key, id(query_fn)): GraphedCall}, {id(query_fn):
        # (query_fn, its StaticInputs)} (held, so an id is never reused
        # while its graphs live), and the graphs' one memory pool
        self._graphs: Dict[tuple, GraphedCall] = {}
        self._graph_inputs: Dict[int, tuple] = {}
        self._pool = None

    def _bucket(self, lv: int) -> int:
        """Current budget for level lv (1-based). Never waits but once: a
        frame's boundary count is taken once its copy to the host has
        landed, and until then the last bucket is reused; the first count
        ever of a level is waited for (one start-up wait), else a pipelined
        loop would run every frame at the caps."""
        cap = self.budgets[lv - 1]
        if not self.auto_budget:
            return cap
        copy = self._last_counts.get(lv)
        if copy is not None and (lv not in self._last_hosts or
                                 copy.ready()):
            self._last_hosts[lv] = int(copy.wait())
            del self._last_counts[lv]
        if lv not in self._last_hosts:
            return self._bucket_used.get(lv, cap)
        need = self._last_hosts[lv]
        if need <= 0 or need > cap:       # overflow last frame -> reset
            self._bucket_used[lv] = cap
            return cap
        want = int(need * self.auto_headroom)
        # geometric ladder, ratio 1.25 quantized to 4096: padded slots pay
        # full query compute, so the waste stays under ~1.25x
        b = 4096
        while b < want:
            b = -(-int(b * 1.25) // 4096) * 4096
        m = self.pad_multiple        # a mesh of 3 or 6 does not divide 4096
        b = min(-(-b // m) * m, cap)
        self._bucket_used[lv] = b
        return b

    def _level0(self, query_fn, query_args, device):
        r0 = self.resolutions[0]
        g = torch.linspace(0.0, 1.0, r0, device=device)
        zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
        pts01 = torch.stack([xx, yy, zz], dim=-1).reshape(1, -1, 3)
        n = pts01.shape[1]
        pad = (-n) % self.pad_multiple
        if pad:
            pts01 = torch.cat([pts01, pts01.new_zeros((1, pad, 3))], dim=1)
        occ = query_fn(_grid_to_world(pts01), *query_args)
        occ = occ[:, :n].reshape(r0, r0, r0)
        evaluated = torch.ones((r0, r0, r0), dtype=torch.bool, device=device)
        return occ, evaluated

    def _upsample(self, occ: torch.Tensor, r: int) -> torch.Tensor:
        _check_ladder(occ, r)
        return lk.upsample(occ)

    def _level_step(self, lv, occ, evaluated, query_fn, budget, query_args):
        """Level ``lv`` from the coarser (occ, evaluated): (occ, evaluated,
        counts [3] = (n_sel, total, overflow), conflicts, residual); on the
        card the level kernels (``kernels/level.py``) around the query."""
        r = self.resolutions[lv]
        _check_ladder(occ, r)
        k = 9 if lv == 1 else (7 if lv == 2 else 3)
        # the dilated boundary minus the voxels evaluated at coarser levels
        # (reference coords_accum, seg3d_lossless.py:236-238): coarse (i, j,
        # k) lands at fine (2i, 2j, 2k)
        occ_up, ev, idx, pts, counts = lk.level_select(occ, evaluated, k,
                                                       budget)

        def eval_at(pts):
            vals = query_fn(pts[None], *query_args)
            return vals[0, :, 0].to(occ_up.dtype).contiguous()

        vals = eval_at(pts)
        conflicts = residual = None
        if self.exact:
            interp = occ_up.clone().reshape(-1)    # the writes are in place
        occ, ev = lk.level_write(occ_up, ev, idx, counts, vals)
        if self.exact:
            occ, ev, conflicts, residual = self._resolve_conflicts(
                r, interp, occ, ev, idx, vals, counts, budget, eval_at)
        return occ, ev, counts, conflicts, residual

    def _resolve_conflicts(self, r, interp_flat, occ, evaluated, idx, vals,
                           counts, budget, eval_at):
        """The reference's conflict resolution (seg3d_lossless.py:388-471)
        in ``conflict_rounds`` rounds: a conflict is an evaluated point
        whose value and the interpolation it replaced lie on opposite sides
        of the balance; its clamped 3^3 neighbourhood, minus what is
        evaluated, is compacted into ``cbudget`` points and evaluated. The
        residual counts the conflicts among the last round's points, whose
        neighbourhoods no round examined (0: converged)."""
        m = self.pad_multiple
        cbudget = -(-max(budget // 2, 1024) // m) * m
        offsets = device_constant(_NEIGHBOURS, torch.int64, idx.device)

        def conflicting(idx, vals, counts):
            alive = torch.arange(len(idx), device=idx.device) < counts[0]
            interp = interp_flat[torch.where(alive, idx,
                                             torch.zeros_like(idx))]
            return alive & ((vals - BALANCE) * (interp - BALANCE) < 0)

        n_conflicts = torch.zeros((), dtype=torch.int64, device=idx.device)
        for _ in range(self.conflict_rounds):
            conflict = conflicting(idx, vals, counts)
            n_conflicts = n_conflicts + conflict.sum()
            czyx = torch.stack([idx // (r * r), (idx // r) % r, idx % r], -1)
            nb = torch.clamp(czyx[None] + offsets[:, None], 0, r - 1)
            nidx = (nb[..., 0] * r + nb[..., 1]) * r + nb[..., 2]
            nidx = torch.where(conflict[None], nidx,
                               torch.full_like(nidx, r ** 3))
            flags = torch.zeros(r ** 3 + 1, dtype=torch.bool,
                                device=idx.device)
            flags[nidx.reshape(-1)] = flags.new_ones(())
            flags = flags[:-1] & ~evaluated.reshape(-1)
            idx, pts, counts = lk.compact(flags.reshape(r, r, r), cbudget)
            vals = eval_at(pts)
            occ, evaluated = lk.level_write(occ, evaluated, idx, counts,
                                            vals)
        residual = conflicting(idx, vals, counts).sum()
        return occ, evaluated, n_conflicts, residual

    @torch.no_grad()
    def __call__(self, query_fn: Callable[..., torch.Tensor],
                 query_args: tuple = (), graph_levels: bool = False):
        """Returns (occ [R, R, R] float32 in [z, y, x] layout, stats).

        ``stats``: ``levelN_points`` (boundary count, 0-d device tensor),
        ``levelN_overflow``, in exact mode ``levelN_conflicts`` and
        ``levelN_residual``, and in faster mode ``coarse_occ`` (the grid
        before the final interpolation-only upsample). With
        ``virtual_final`` the returned grid is ``coarse_occ`` itself and
        ``stats["final_res"]`` the resolution of the level not written.

        ``graph_levels`` (faster mode on a CUDA engine; the JAX engine's
        ``jit_levels``): level 0, each (level, budget) step with its
        query, and the final upsample are each captured once as a CUDA
        graph (``recon/graphs.py``) and replayed after, keyed as the JAX
        package's executables, with ``query_fn`` itself held by the cache:
        a new ``query_fn`` captures new graphs. ``query_args`` are their
        real arguments: the tensors of the first call become the graphs'
        input buffers, and a later call's tensor at another address is
        copied into its buffer first. The graphs of an engine share one
        memory pool and replay on the current stream. The returned grid
        is the final graph's buffer, rewritten by the engine's next call
        (work enqueued on it before is safe by stream order); ``stats``
        are the call's own. The first call at a new bucket waits for the
        card while it captures."""
        if graph_levels:
            return self._replay(query_fn, query_args)
        res = self.resolutions
        stats: Dict[str, torch.Tensor] = {}
        occ, evaluated = self._level0(query_fn, query_args, self.device)
        for lv in range(1, len(res)):
            if lv == len(res) - 1 and self.faster:
                stats["coarse_occ"] = occ
                if self.virtual_final:
                    stats["final_res"] = res[lv]
                    break
                occ = self._upsample(occ, res[lv])
                break
            budget = self._bucket(lv)
            occ, evaluated, counts, conflicts, residual = self._level_step(
                lv, occ, evaluated, query_fn, budget, query_args)
            self._level_stats(stats, lv, counts)
            if self.exact:
                stats[f"level{lv}_conflicts"] = conflicts
                stats[f"level{lv}_residual"] = residual
        return occ, stats

    def _level_stats(self, stats, lv, counts) -> None:
        if self.auto_budget:               # taken at a later frame
            self._last_counts[lv] = HostCopy(counts[1])
        stats[f"level{lv}_points"] = counts[1]
        stats[f"level{lv}_overflow"] = counts[2]

    def _replay(self, query_fn, query_args):
        """``__call__`` with ``graph_levels``."""
        if self.device.type != "cuda":
            raise ValueError(f"graph_levels needs a CUDA engine, this one is "
                             f"on {self.device}")
        if self.exact or not self.faster:
            raise ValueError("graph_levels replays the faster mode only")
        held = self._graph_inputs.get(id(query_fn))
        if held is None or held[0] is not query_fn:
            held = (query_fn, StaticInputs(tuple(query_args)))
            self._graph_inputs[id(query_fn)] = held
        args = held[1].load(tuple(query_args))
        if self._pool is None:
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()

        def graph(key, fn):
            call = self._graphs.get((key, id(query_fn)))
            if call is None:
                call = GraphedCall(fn, self._pool)
                self._graphs[(key, id(query_fn))] = call
            return call

        res = self.resolutions
        stats: Dict[str, torch.Tensor] = {}
        with torch.cuda.device(self.device):
            occ, evaluated = graph(("l0",), lambda *qa: self._level0(
                query_fn, qa, self.device))(*args)
            for lv in range(1, len(res)):
                if lv == len(res) - 1:
                    # the call's own copy: the next call's graphs rewrite
                    # the level's buffer
                    stats["coarse_occ"] = occ.clone()
                    if self.virtual_final:
                        stats["final_res"] = res[lv]
                        return stats["coarse_occ"], stats
                    occ = graph(("up", lv), lambda o, r=res[lv]:
                                self._upsample(o, r))(occ)
                    break
                budget = self._bucket(lv)
                occ, evaluated, counts = graph(
                    ("step", lv, budget),
                    lambda o, e, *qa, lv=lv, b=budget: self._level_step(
                        lv, o, e, query_fn, b, qa)[:3])(occ, evaluated,
                                                        *args)
                self._level_stats(stats, lv, counts.clone())
        return occ, stats
