"""On-device iso-surface extraction, lattice path (``icon_tpu.recon.marching``).

Marching tetrahedra (Kuhn 6-tet subdivision) emitting the lattice wire:
unique vertices as (lattice edge id, fraction along the edge) and active
cells as (cell id, 8 corner-inside bits). Faces never exist on the device;
the host derives them from the corner bits through the same (tet, case)
tables (:mod:`icon_tpu_torch.recon.lattice_host`). Every lattice edge has
exactly one owner cell, so vertices are unique by construction.

Edge ids ``plin * 8 + dir`` are int64 on the device (the JAX package's int32
ids wrap past ~645^3). The wire is word-for-word the JAX package's: wire v2
(implicit edge ids, the serving default) carries no edge ids at all; wire
v1 carries them as int32 and raises for a grid whose ids do not fit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from icon_tpu_torch.recon.engine import _compact
from icon_tpu_torch.recon.lattice_host import (_CORNER_OFF, _EDGE_SLOTS,
                                               decode_lattice)

_INT32_MAX = 2 ** 31 - 1
_INT64_MAX = 2 ** 63 - 1
_HEADROOM = 1.3         # buffer and pack sizes over the measured counts


class LatticeOut(NamedTuple):
    vert_eid: torch.Tensor     # [max_verts] int64 sorted unique edge ids
    vert_s: torch.Tensor       # [max_verts] f32 fraction from the lo end
    cell_id: torch.Tensor      # [max_cells] int64 linear cell ids
    cell_bits: torch.Tensor    # [max_cells] int32 (low 8 bits: corners)
    n_verts: torch.Tensor      # 0-d, clamped to max_verts
    n_cells: torch.Tensor      # 0-d, clamped to max_cells
    n_verts_total: torch.Tensor  # true count; > n_verts = overflow
    n_cells_total: torch.Tensor
    grid_shape: Tuple[int, int, int]   # (D, H, W) of the marched grid


def _active_cells(occ: torch.Tensor, iso: float, max_cells: int,
                  coarse_occ: Optional[torch.Tensor],
                  max_candidates: Optional[int] = None):
    """Candidate cells. Returns (cx, cy, cz, cell_idx, alive_cells,
    n_cells, n_cells_total), each [max_cells] except the 0-d counts.

    With ``coarse_occ`` (``occ`` is its 2x align_corners upsample sliced by
    one), every mixed coarse cell expands into its 8 fine cells (buffer
    ``max_candidates``); those that are exactly mixed at fine resolution
    are compacted into the [max_cells] output."""
    D, H, W = occ.shape
    dev = occ.device
    inside = occ > iso
    cw, ch = W - 1, H - 1

    def corner(arr, c, d_, h_, w_):
        dx, dy, dz = (int(o) for o in _CORNER_OFF[c])
        return arr[dz:dz + d_ - 1, dy:dy + h_ - 1, dx:dx + w_ - 1]

    alive_range = torch.arange(max_cells, device=dev)
    if coarse_occ is None:
        cnt = sum(corner(inside, c, D, H, W).to(torch.int8)
                  for c in range(8))
        active = (cnt > 0) & (cnt < 8)
        cell_idx, n_cells, n_cells_total = _compact(active.reshape(-1),
                                                    max_cells)
        cz = cell_idx // (ch * cw)
        cy = (cell_idx // cw) % ch
        cx = cell_idx % cw
        return cx, cy, cz, cell_idx, alive_range < n_cells, n_cells, \
            n_cells_total

    Dc, Hc, Wc = coarse_occ.shape
    in_c = coarse_occ > iso
    cntc = sum(corner(in_c, c, Dc, Hc, Wc).to(torch.int8) for c in range(8))
    mixed = (cntc > 0) & (cntc < 8)
    nc_budget = (max_candidates or max_cells) // 8
    idxc, n_c, n_mixed_total = _compact(mixed.reshape(-1), nc_budget)
    ccz = idxc // ((Hc - 1) * (Wc - 1))
    ccy = (idxc // (Wc - 1)) % (Hc - 1)
    ccx = idxc % (Wc - 1)
    # coarse cell c covers fine (sliced-by-one) cells {2c-1, 2c} per axis
    offs = torch.as_tensor(_CORNER_OFF, dtype=torch.int64, device=dev)
    fx = 2 * ccx[:, None] - 1 + offs[None, :, 0]
    fy = 2 * ccy[:, None] - 1 + offs[None, :, 1]
    fz = 2 * ccz[:, None] - 1 + offs[None, :, 2]
    valid = ((fx >= 0) & (fx < cw) & (fy >= 0) & (fy < ch) &
             (fz >= 0) & (fz < D - 1) &
             (torch.arange(nc_budget, device=dev)[:, None] < n_c))
    kx = torch.clamp(fx, 0, cw - 1).reshape(-1)
    ky = torch.clamp(fy, 0, ch - 1).reshape(-1)
    kz = torch.clamp(fz, 0, D - 2).reshape(-1)
    cand_idx = (kz * ch + ky) * cw + kx                   # [mcand]

    # exact mixed test: separable all-inside / any-inside reductions
    ai = inside[:, :, :-1] & inside[:, :, 1:]
    ao = inside[:, :, :-1] | inside[:, :, 1:]
    ai = ai[:, :-1] & ai[:, 1:]
    ao = ao[:, :-1] | ao[:, 1:]
    mixedv = ((ao[:-1] | ao[1:]) & ~(ai[:-1] & ai[1:])).reshape(-1)
    alive_cand = valid.reshape(-1) & mixedv[cand_idx]

    cpos, n_cells, n_alive_total = _compact(alive_cand, max_cells)
    # each dropped mixed coarse cell hides up to 8 fine candidates
    n_cells_total = n_alive_total + 8 * torch.clamp(
        n_mixed_total - nc_budget, min=0)
    return kx[cpos], ky[cpos], kz[cpos], cand_idx[cpos], \
        alive_range < n_cells, n_cells, n_cells_total


def marching_lattice(occ: torch.Tensor, iso: float = 0.5,
                     max_cells: int = 1 << 18, max_verts: int = 1 << 19,
                     coarse_occ: Optional[torch.Tensor] = None,
                     max_candidates: Optional[int] = None) -> LatticeOut:
    """Marching tetrahedra over ``occ [D, H, W]`` ([z, y, x]) emitting the
    lattice codec; see the module docstring."""
    D, H, W = occ.shape
    dev = occ.device
    cx, cy, cz, cell_idx, alive_cells, n_cells, n_cells_total = \
        _active_cells(occ, iso, max_cells, coarse_occ, max_candidates)
    offs = torch.as_tensor(_CORNER_OFF, dtype=torch.int64, device=dev)
    lin = ((cz[:, None] + offs[None, :, 2]) * H +
           (cy[:, None] + offs[None, :, 1])) * W + \
        (cx[:, None] + offs[None, :, 0])
    cvals = occ.reshape(-1)[lin]                          # [NC, 8]
    return _lattice_emit(cvals, cx, cy, cz, cell_idx, alive_cells, n_cells,
                         n_cells_total, (D, H, W), iso, max_verts)


def _lattice_emit(cvals, cx, cy, cz, cell_idx, alive_cells, n_cells,
                  n_cells_total, fine_shape, iso, max_verts) -> LatticeOut:
    """Per-cell corner values -> owned crossing edges -> (edge id,
    fraction) vertices sorted by edge id + (cell id, corner bits)."""
    D, H, W = fine_shape
    cw, ch = W - 1, H - 1
    dev = cvals.device
    max_cells = cx.shape[0]
    cbits = (cvals > iso).to(torch.int32)

    slots = torch.as_tensor(_EDGE_SLOTS, dtype=torch.int64, device=dev)
    v_lo = cvals[:, slots[:, 0]]                          # [NC, 19]
    v_hi = cvals[:, slots[:, 1]]
    crossing = (v_lo > iso) != (v_hi > iso)
    olo = torch.as_tensor(_CORNER_OFF[_EDGE_SLOTS[:, 0]], dtype=torch.int64,
                          device=dev)                     # [19, 3] (x, y, z)
    own = (((olo[None, :, 0] == 0) | (cx[:, None] == cw - 1)) &
           ((olo[None, :, 1] == 0) | (cy[:, None] == ch - 1)) &
           ((olo[None, :, 2] == 0) | (cz[:, None] == D - 2)))
    valid = crossing & own & alive_cells[:, None]

    denom = v_hi - v_lo
    s = torch.clamp((iso - v_lo) / torch.where(denom == 0,
                                               torch.ones_like(denom), denom),
                    0.0, 1.0)
    plin = ((cz[:, None] + olo[None, :, 2]) * H +
            (cy[:, None] + olo[None, :, 1])) * W + \
        (cx[:, None] + olo[None, :, 0])
    eid = plin * 8 + slots[None, :, 2]                    # [NC, 19] int64

    vpos, n_verts, n_verts_total = _compact(valid.reshape(-1), max_verts)
    vert_eid = eid.reshape(-1)[vpos]
    vert_s = s.reshape(-1)[vpos]
    # canonical wire order: ascending edge id; dead slots sort to the tail
    vert_eid = torch.where(torch.arange(max_verts, device=dev) < n_verts,
                           vert_eid, torch.full_like(vert_eid, _INT64_MAX))
    vert_eid, order = torch.sort(vert_eid, stable=True)
    vert_s = vert_s[order]

    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    cbyte = (cbits * weights).sum(-1, dtype=torch.int32)
    return LatticeOut(vert_eid, vert_s, cell_idx, cbyte,
                      torch.clamp(n_verts, max=max_verts),
                      torch.clamp(n_cells, max=max_cells),
                      n_verts_total, n_cells_total, (D, H, W))


def _pack4(b: torch.Tensor) -> torch.Tensor:
    """Little-endian u8 x4 per int32 word (zero padded)."""
    pad = (-b.shape[0]) % 4
    b8 = torch.cat([b.to(torch.uint8), b.new_zeros(pad, dtype=torch.uint8)])
    return b8.view(torch.int32)


def pack_lattice(out: LatticeOut, bucket: int = 16384,
                 sizes: Optional[Tuple[int, int]] = None,
                 implicit_eid: bool = False):
    """One int32 device buffer: [header 4 | vert_eid nvb (v1 only) |
    vert_s u8 x4/word | cell_id ncb | cell_bits u8 x4/word]. The header
    holds (n_verts, n_cells, implicit flag, 0), written on the device, so
    packing never waits for it. ``sizes`` = (n_verts, n_cells) upper bounds,
    rounded up to ``bucket``; the decoder reports an overflow when the true
    counts exceed them. Returns (buf, nvb, ncb)."""
    cap_v = out.vert_eid.shape[0]
    cap_c = out.cell_id.shape[0]
    want_v, want_c = sizes if sizes is not None else (cap_v, cap_c)
    if want_v <= 0 or want_c <= 0:
        want_v, want_c = cap_v, cap_c
    nvb = min(-(-want_v // bucket) * bucket, cap_v)
    ncb = min(-(-want_c // bucket) * bucket, cap_c)
    dev = out.vert_eid.device
    counts = torch.stack([out.n_verts, out.n_cells,
                          torch.tensor(int(implicit_eid), device=dev),
                          torch.tensor(0, device=dev)]).to(torch.int32)
    parts = [counts]
    if not implicit_eid:
        D, H, W = out.grid_shape
        if D * H * W * 8 > _INT32_MAX:
            raise ValueError(f"grid {out.grid_shape}: edge ids do not fit "
                             f"the int32 wire v1; use implicit_eid=True")
        eid = out.vert_eid[:nvb]
        parts.append(torch.where(eid == _INT64_MAX,
                                 torch.full_like(eid, _INT32_MAX),
                                 eid).to(torch.int32))
    s8 = torch.clamp(torch.round(out.vert_s[:nvb] * 255.0), 0, 255)
    parts += [_pack4(s8), out.cell_id[:ncb].to(torch.int32),
              _pack4(out.cell_bits[:ncb] & 0xFF)]
    return torch.cat(parts), nvb, ncb


class AutoMarcher:
    """Lattice marcher (wire v2) with buffer autotuning across frames: each
    frame sizes its cell and vertex buffers from the previous frame's
    measured totals x 1.3, snapped to a geometric bucket ladder; the first
    frame and any frame after an overflow use the caps. The pack sizes come
    from the latest measured counts the same way."""

    def __init__(self, max_cells: int = 1 << 18, max_tris: int = 1 << 20,
                 max_verts: Optional[int] = None, iso: float = 0.5,
                 slice_one: bool = False):
        """``slice_one``: drop the first slice of each axis (the engine and
        export grid convention, seg3d_lossless.py:585). ``max_tris`` only
        sets the default vertex cap (2 x max_tris, at most 2^21)."""
        self.caps = (max_cells, max_verts or min(2 * max_tris, 1 << 21))
        self.iso = iso
        self.slice_one = slice_one
        self._last: Optional[torch.Tensor] = None   # device [4] counts
        self._counts_host: Optional[Tuple[int, ...]] = None
        self._dims: Optional[Tuple[int, int]] = None

    @staticmethod
    def _bucket(want: int, cap: int) -> int:
        b = 8192
        while b < want:
            b = -(-int(b * 1.25) // 8192) * 8192
        return min(b, cap)

    def _counts(self) -> Optional[Tuple[int, ...]]:
        """(n_cells_total, n_verts_total, n_verts, n_cells) of the latest
        march, read back to the host once (a blocking copy)."""
        if self._last is not None:
            self._counts_host = tuple(int(v) for v in self._last.tolist())
            self._last = None
        return self._counts_host

    def _sizes(self) -> Tuple[int, int]:
        """(cell, vertex) buffer sizes for the next march."""
        c = self._counts()
        if c is None:
            return self.caps
        ncells, nverts = c[0], c[1]
        if ncells <= 0 or nverts <= 0 or ncells > self.caps[0] \
                or nverts > self.caps[1]:
            return self.caps                       # overflow -> reset
        return (self._bucket(int(ncells * _HEADROOM), self.caps[0]),
                self._bucket(int(nverts * _HEADROOM), self.caps[1]))

    @torch.no_grad()
    def __call__(self, occ: torch.Tensor,
                 coarse_occ: Optional[torch.Tensor] = None) -> LatticeOut:
        mc, mv = self._sizes()
        if self.slice_one:
            occ = occ[1:, 1:, 1:]
        self._dims = (occ.shape[1], occ.shape[2])
        # the candidate (pre-filter) buffer stays at the cap: the autotuned
        # mc tracks the smaller exact mixed set
        out = marching_lattice(occ, iso=self.iso, max_cells=mc, max_verts=mv,
                               coarse_occ=coarse_occ,
                               max_candidates=self.caps[0])
        self._last = torch.stack([out.n_cells_total, out.n_verts_total,
                                  out.n_verts, out.n_cells])
        return out

    def pack(self, out: LatticeOut):
        """Device-side pack sized from the measured counts x headroom (first
        frame: the full buffers). Returns a token for :meth:`unpack`."""
        c = self._counts()
        sizes = (int(c[1] * _HEADROOM),
                 int(c[0] * _HEADROOM)) if c is not None else None
        packed = pack_lattice(out, sizes=sizes, implicit_eid=True)
        return packed, out, self._dims

    def unpack(self, token) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking transfer + host decode of a :meth:`pack` token; a frame
        that outgrew the packed sizes re-packs at full size."""
        packed, out, (H, W) = token
        verts, faces, overflow = decode_lattice(packed, H, W,
                                                return_overflow=True)
        if overflow:
            verts, faces = decode_lattice(pack_lattice(out), H, W)
        return verts, faces
