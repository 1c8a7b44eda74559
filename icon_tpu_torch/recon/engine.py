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

from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
from icon_tpu_torch.ops.voxelize import smooth_conv3d

B_MIN = (-1.0, 1.0, -1.0)
B_MAX = (1.0, -1.0, 1.0)
BALANCE = 0.5           # the occupancy iso level
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


def _compact(mask_flat: torch.Tensor, budget: int):
    """First ``budget`` true indices of ``mask_flat`` in linear order, by a
    prefix sum and a scatter (no ``torch.nonzero``, so no host sync).
    Padded slots hold n - 1. Returns (idx [budget] int64, count = min(total,
    budget), total) with the counts as 0-d device tensors."""
    n = mask_flat.shape[0]
    dev = mask_flat.device
    pos = torch.cumsum(mask_flat.to(torch.int64), 0) - 1
    total = pos[-1] + 1 if n else torch.zeros((), dtype=torch.int64,
                                               device=dev)
    dest = torch.where(mask_flat & (pos < budget), pos,
                       torch.full_like(pos, budget))     # dropped -> slot
    idx = torch.full((budget + 1,), max(n - 1, 0), dtype=torch.int64,
                     device=dev)
    idx.scatter_(0, dest, torch.arange(n, device=dev))
    return idx[:budget], torch.clamp(total, max=budget), total


def _grid_to_world(coords01: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] grid space (x, y, z) -> world (align_corners)."""
    bmin = device_constant(B_MIN, coords01.dtype, coords01.device)
    bmax = device_constant(B_MAX, coords01.dtype, coords01.device)
    return coords01 * (bmax - bmin) + bmin


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


def _set_dropped(flat: torch.Tensor, idx: torch.Tensor,
                 vals) -> torch.Tensor:
    """``flat[idx] = vals`` where idx == len(flat) means "drop": writes into
    a buffer one longer and slices the extra slot off. A Python scalar
    ``vals`` is filled on the device (indexing a CUDA tensor with a host
    scalar copies it there, which waits for the stream)."""
    buf = torch.cat([flat, flat.new_zeros(1)])
    buf[idx] = vals if torch.is_tensor(vals) else buf.new_full((), vals)
    return buf[:-1]


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
        return resize3d_trilinear_align_corners(occ[None, None],
                                                (r, r, r))[0, 0]

    def _level_step(self, lv, occ, evaluated, query_fn, budget, query_args):
        r = self.resolutions[lv]
        occ_up = self._upsample(occ, r)
        valid = self._upsample((occ > BALANCE).to(torch.float32), r)
        boundary = (valid > 0.0) & (valid < 1.0)

        k = 9 if lv == 1 else (7 if lv == 2 else 3)
        boundary = smooth_conv3d(boundary.to(torch.float32), k) > 0

        # exclude voxels evaluated at coarser levels (reference
        # coords_accum, seg3d_lossless.py:236-238): coarse (i, j, k) lands
        # at fine (2i, 2j, 2k)
        ev = torch.zeros((r, r, r), dtype=torch.bool, device=occ.device)
        ev[::2, ::2, ::2] = evaluated
        boundary = boundary & ~ev

        idx, n_sel, n_total = _compact(boundary.reshape(-1), budget)

        def eval_at(idx):
            cz = idx // (r * r)
            cy = (idx // r) % r
            cx = idx % r
            pts01 = torch.stack([cx, cy, cz], -1).to(torch.float32) / (r - 1)
            vals = query_fn(_grid_to_world(pts01[None]), *query_args)
            return vals[0, :, 0].to(occ_up.dtype)

        def write(occ, evaluated, idx, n, vals):
            alive = torch.arange(len(idx), device=idx.device) < n
            safe = torch.where(alive, idx, torch.full_like(idx, r ** 3))
            occ = _set_dropped(occ.reshape(-1), safe, vals).reshape(r, r, r)
            evaluated = _set_dropped(evaluated.reshape(-1), safe,
                                     True).reshape(r, r, r)
            return occ, evaluated, alive

        vals = eval_at(idx)
        occ, evaluated, alive = write(occ_up, ev, idx, n_sel, vals)
        conflicts = residual = None
        if self.exact:
            occ, evaluated, conflicts, residual = self._resolve_conflicts(
                r, occ_up.reshape(-1), occ, evaluated, idx, vals, alive,
                budget, eval_at, write)
        return occ, evaluated, n_total, conflicts, residual

    def _resolve_conflicts(self, r, interp_flat, occ, evaluated, idx, vals,
                           alive, budget, eval_at, write):
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

        def conflicting(idx, vals, alive):
            interp = interp_flat[torch.where(alive, idx,
                                             torch.zeros_like(idx))]
            return alive & ((vals - BALANCE) * (interp - BALANCE) < 0)

        n_conflicts = torch.zeros((), dtype=torch.int64, device=idx.device)
        for _ in range(self.conflict_rounds):
            conflict = conflicting(idx, vals, alive)
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
            idx, n_sel, _ = _compact(flags, cbudget)
            vals = eval_at(idx)
            occ, evaluated, alive = write(occ, evaluated, idx, n_sel, vals)
        residual = conflicting(idx, vals, alive).sum()
        return occ, evaluated, n_conflicts, residual

    @torch.no_grad()
    def __call__(self, query_fn: Callable[..., torch.Tensor],
                 query_args: tuple = ()):
        """Returns (occ [R, R, R] float32 in [z, y, x] layout, stats).

        ``stats``: ``levelN_points`` (boundary count, 0-d device tensor),
        ``levelN_overflow``, in exact mode ``levelN_conflicts`` and
        ``levelN_residual``, and in faster mode ``coarse_occ`` (the grid
        before the final interpolation-only upsample). With
        ``virtual_final`` the returned grid is ``coarse_occ`` itself and
        ``stats["final_res"]`` the resolution of the level not written."""
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
            occ, evaluated, n_total, conflicts, residual = self._level_step(
                lv, occ, evaluated, query_fn, budget, query_args)
            if self.auto_budget:               # taken at a later frame
                self._last_counts[lv] = HostCopy(n_total)
            stats[f"level{lv}_points"] = n_total
            stats[f"level{lv}_overflow"] = torch.clamp(n_total - budget,
                                                       min=0)
            if self.exact:
                stats[f"level{lv}_conflicts"] = conflicts
                stats[f"level{lv}_residual"] = residual
        return occ, stats
