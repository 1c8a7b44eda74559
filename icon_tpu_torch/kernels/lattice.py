"""The serving marcher's lattice kernels and their plain twins: the active
cells, the lattice emit and the decode of the mesh on the card.

``recon/marching.py`` calls the wrappers. A CUDA tensor launches
``csrc/lattice.cu`` or raises; a CPU tensor takes the plain version (the
JAX package's function in PyTorch: ``_active_cells`` with
``_compact_indices``, ``_lattice_emit`` with a stable ``torch.sort`` in
place of ``lax.sort``, and the host codec's decode,
``csrc/latticecodec.cc:77-150``).

- :func:`lattice_cells`: each mixed cell of the coarse grid expands into
  its 8 fine cells, each tested exactly on its own 8 corners; the alive
  ones in candidate order, the first ``max_cells``, with their
  coordinates, linear ids and corner values (without a coarse grid, the
  fine grid's mixed cells in linear order). One launch: tiles of whole
  rows of up to ``CELLS_TILE_CELLS`` cells, the mixed bits from ballots of
  each point row's inside bits, the mixed cells listed in shared memory
  and expanded a lane a (mixed cell, fine cell) pair.
- :func:`lattice_emit`: each alive cell's corner byte and owned crossing
  edges; the first ``max_verts`` in (cell, slot) order, as (edge id,
  fraction) in ascending edge-id order. One cooperative launch a call, its
  phases between grid-wide barriers: the emit, then the rank tables of the
  kept ids (the summary of the 32-id words that hold one, ``sum_rank``,
  ``word_rank``), then each id written at its rank. The tables stay with
  the lattice on the card (``LatticeOut.rank``) for the decode.
- :func:`lattice_decode`: the host decoder's mesh (wire v1 at full size)
  from a :class:`LatticeOut`, in one int32 buffer ``[header 4 | verts 3
  nvb f32 | faces 3 nfb i32]``, header (vertices, faces, cells, 0), for one
  copy to the host (:func:`unpack_decoded`). One launch: a cell a thread,
  its faces' edge ids ranked in O(1) through the emit's rank tables
  (:func:`rank_lookup_plain` is that lookup in PyTorch), each tile's faces
  written as one run. A lattice whose tables were released
  (:func:`release_rank`) or that holds none gets them anew from its sorted
  ids (one more cooperative launch, the emit's rank phases).

Rows past the counts: :func:`lattice_cells` and :func:`lattice_emit` give
zeros (and INT64_MAX edge ids) in both versions; the decode buffer's rows
past its counts are unspecified. Each call's buffers and scratch are its
own (the cells and decode entries zero their scratch with
``cudaMemsetAsync`` on the call's stream; the emit's phases write every
word they read), so host threads on one stream share no state; a
lattice's rank tables are its emit's own, views of the one workspace that
holds its outputs.

``launches_cells``, ``launches_emit`` and ``launches_decode`` count the
wrappers' calls on the card (a call is one count for its launches).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.recon.engine import _compact
from icon_tpu_torch.recon.lattice_host import (_CORNER_OFF, _EDGE_SLOTS,
                                               _host_tables_flat)

INT64_MAX = 2 ** 63 - 1
EMIT_THREADS = 512        # csrc/lattice.cu's kEmitThreads (emit and rank)
CELLS_TILE_CELLS = 4096   # kCellsTileCells: lattice_cells' tiles at most
DECODE_TILE_CELLS = 128   # csrc/lattice.cu's kDecodeThreads
HEADER = 4                # int32 words before the decoded vertices

launches_cells = 0        # lattice_cells calls on the card since the reset
launches_emit = 0
launches_decode = 0

# csrc/lattice.cu's kEmitBlocksPerSm: the cooperative grids (emit, rank
# tables) take at most this many blocks an SM (the C entry also clamps
# them to the blocks the card holds at once)
EMIT_BLOCKS_PER_SM = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tables_on = set()        # device indices whose constant tables are set


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
    # on the card, from lattice_emit: [summary, sum_rank, word_rank], the
    # decode's rank tables of the kept ids, int32 views of the emit's
    # workspace (emptied by release_rank)
    rank: Optional[list] = None


class Cells(NamedTuple):
    cx: torch.Tensor           # [max_cells] int64 cell coordinates
    cy: torch.Tensor
    cz: torch.Tensor
    cell_idx: torch.Tensor     # [max_cells] int64 linear cell ids
    cvals: torch.Tensor        # [max_cells, 8] f32, corner c = x + 2y + 4z
    n_cells: torch.Tensor      # 0-d int64, min(alive, max_cells)
    n_cells_total: torch.Tensor  # 0-d int64; > n_cells = overflow


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["lattice.cu"])
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            cf = ctypes.c_float
            lib.icon_lattice_set_tables.argtypes = [vp] * 4
            lib.icon_lattice_cells.argtypes = [vp, ci, ci, ci, vp, vp, ci, ci,
                                               ci, vp, cf, cl, cl, vp, vp, vp,
                                               vp]
            lib.icon_lattice_emit.argtypes = [vp, vp, vp, vp, vp, cl, ci, ci,
                                              ci, cf, cl, cl, vp, vp, vp, vp,
                                              cl, vp, vp, vp, vp, vp, vp, vp]
            lib.icon_lattice_rank.argtypes = [vp, vp, cl, cl, vp, vp, vp,
                                              vp, cl, vp]
            lib.icon_lattice_decode.argtypes = [vp, vp, vp, cl, vp, vp, vp,
                                                cl, ci, ci, cl, vp, vp, vp,
                                                cl, cl, vp, vp, vp]
            lib.icon_lattice_error_string.argtypes = [ci]
            lib.icon_lattice_error_string.restype = ctypes.c_char_p
            tiles = (lib.icon_lattice_emit_threads,
                     lib.icon_lattice_cells_tile_cells,
                     lib.icon_lattice_decode_tile_cells)
            for fn in tiles:
                fn.argtypes = []
            for fn in (lib.icon_lattice_set_tables, lib.icon_lattice_cells,
                       lib.icon_lattice_emit, lib.icon_lattice_rank,
                       lib.icon_lattice_decode, *tiles):
                fn.restype = ci
            if tuple(fn() for fn in tiles) != (
                    EMIT_THREADS, CELLS_TILE_CELLS, DECODE_TILE_CELLS):
                raise RuntimeError("csrc/lattice.cu's block sizes differ "
                                   "from kernels/lattice.py's")
            _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.icon_lattice_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


@functools.lru_cache(maxsize=1)
def _cell_face_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The decode's tables by corner byte, from the host codec's (tet,
    case) tables: (used [256] u32, the edge slots its faces use, a bit a
    slot of ``_EDGE_SLOTS``; nf [256] u8, its faces (valid triangles);
    faces [256, 36] u8, their slot triples in the codec's order, tet then
    triangle). A face corner's (lo corner, direction) is the slot's."""
    tet_case, tri_lo, tri_dcode, tri_valid = _host_tables_flat()
    slot_of = {(int(lo), int(d)): s for s, (lo, _, d) in
               enumerate(_EDGE_SLOTS)}
    used = np.zeros(256, np.uint32)
    nf = np.zeros(256, np.uint8)
    faces = np.zeros((256, 36), np.uint8)
    for bits in range(256):
        for t in range(6):
            e96 = t * 16 + int(tet_case[bits * 6 + t])
            for k in range(2):
                if not tri_valid[e96 * 2 + k]:
                    continue
                for j in range(3):
                    i = (e96 * 2 + k) * 3 + j
                    s = slot_of[(int(tri_lo[i]), int(tri_dcode[i]))]
                    faces[bits, 3 * nf[bits] + j] = s
                    used[bits] |= 1 << s
                nf[bits] += 1
    return used, nf, faces


def _lib_on(device: torch.device) -> ctypes.CDLL:
    """The library, with the edge slots and the decode's tables on
    ``device``."""
    lib = _load()
    with _lock:
        if device.index not in _tables_on:
            tables = [np.ascontiguousarray(_EDGE_SLOTS, dtype=np.uint8)]
            tables += [np.ascontiguousarray(t) for t in _cell_face_tables()]
            with torch.cuda.device(device):
                _raise_on(lib, lib.icon_lattice_set_tables(
                    *(t.ctypes.data for t in tables)),
                    "icon_lattice_set_tables")
            _tables_on.add(device.index)
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid_blocks(device: torch.device) -> Tuple[int, int]:
    """(The blocks a cooperative launch on ``device`` may take at most,
    the bytes of its block totals: three scans' u32 rows, each rounded up
    to 16 bytes)."""
    blocks = EMIT_BLOCKS_PER_SM * _sm_count(device.index)
    return blocks, 3 * 4 * -(-blocks // 4) * 4


def _workspace(device: torch.device, nbytes) -> Tuple[torch.Tensor, list]:
    """One allocation for parts of ``nbytes`` bytes each, every part
    16-byte aligned: (the workspace, int64 words; each part's offset in
    bytes)."""
    offs, at = [], 0
    for n in nbytes:
        offs.append(at)
        at += -(-n // 16) * 16
    return torch.empty((max(at, 16) // 8,), dtype=torch.int64,
                       device=device), offs


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


# --- lattice_cells -----------------------------------------------------------

def _mixed_cells(arr: torch.Tensor, iso: float) -> torch.Tensor:
    """[D-1, H-1, W-1] bool: the cells of ``arr`` whose 8 corners lie on
    both sides of ``iso``."""
    inside = arr > iso
    D, H, W = arr.shape

    def corner(c):
        dx, dy, dz = (int(o) for o in _CORNER_OFF[c])
        return inside[dz:dz + D - 1, dy:dy + H - 1, dx:dx + W - 1]

    cnt = sum(corner(c).to(torch.int8) for c in range(8))
    return (cnt > 0) & (cnt < 8)


def _coarse_candidates(coarse_occ: torch.Tensor, iso: float,
                       fine_shape: Tuple[int, int, int], nc_budget: int):
    """The fine cells that the first ``nc_budget`` mixed cells of
    ``coarse_occ`` cover in its 2x upsample sliced by one (``fine_shape``):
    coarse cell c covers fine cells {2c-1, 2c} per axis. Returns (kx, ky,
    kz, cand_idx, valid [nc_budget * 8], n_mixed_total)."""
    D, H, W = fine_shape
    cw, ch = W - 1, H - 1
    Dc, Hc, Wc = coarse_occ.shape
    dev = coarse_occ.device
    idxc, n_c, n_mixed_total = _compact(
        _mixed_cells(coarse_occ, iso).reshape(-1), nc_budget)
    ccz = idxc // ((Hc - 1) * (Wc - 1))
    ccy = (idxc // (Wc - 1)) % (Hc - 1)
    ccx = idxc % (Wc - 1)
    offs = device_constant(_CORNER_OFF, torch.int64, dev)
    fx = 2 * ccx[:, None] - 1 + offs[None, :, 0]
    fy = 2 * ccy[:, None] - 1 + offs[None, :, 1]
    fz = 2 * ccz[:, None] - 1 + offs[None, :, 2]
    valid = ((fx >= 0) & (fx < cw) & (fy >= 0) & (fy < ch) &
             (fz >= 0) & (fz < D - 1) &
             (torch.arange(nc_budget, device=dev)[:, None] < n_c))
    kx = torch.clamp(fx, 0, cw - 1).reshape(-1)
    ky = torch.clamp(fy, 0, ch - 1).reshape(-1)
    kz = torch.clamp(fz, 0, D - 2).reshape(-1)
    return kx, ky, kz, (kz * ch + ky) * cw + kx, valid.reshape(-1), \
        n_mixed_total


def lattice_cells_plain(occ: torch.Tensor, iso: float, max_cells: int,
                        coarse_occ: Optional[torch.Tensor] = None,
                        max_candidates: Optional[int] = None) -> Cells:
    """See :func:`lattice_cells`."""
    D, H, W = occ.shape
    cw, ch = W - 1, H - 1
    dev = occ.device
    if coarse_occ is None:
        cell_idx, n_cells, n_cells_total = _compact(
            _mixed_cells(occ, iso).reshape(-1), max_cells)
        cz = cell_idx // (ch * cw)
        cy = (cell_idx // cw) % ch
        cx = cell_idx % cw
    else:
        nc_budget = (max_candidates or max_cells) // 8
        kx, ky, kz, cand_idx, valid, n_mixed_total = _coarse_candidates(
            coarse_occ, iso, (D, H, W), nc_budget)
        # exact mixed test: separable all-inside / any-inside reductions
        inside = occ > iso
        ai = inside[:, :, :-1] & inside[:, :, 1:]
        ao = inside[:, :, :-1] | inside[:, :, 1:]
        ai = ai[:, :-1] & ai[:, 1:]
        ao = ao[:, :-1] | ao[:, 1:]
        mixedv = ((ao[:-1] | ao[1:]) & ~(ai[:-1] & ai[1:])).reshape(-1)
        alive_cand = valid & mixedv[cand_idx]
        cpos, n_cells, n_alive_total = _compact(alive_cand, max_cells)
        # each dropped mixed coarse cell hides up to 8 fine candidates
        n_cells_total = n_alive_total + 8 * torch.clamp(
            n_mixed_total - nc_budget, min=0)
        cx, cy, cz, cell_idx = kx[cpos], ky[cpos], kz[cpos], cand_idx[cpos]
    alive = torch.arange(max_cells, device=dev) < n_cells
    cx, cy, cz, cell_idx = (torch.where(alive, a, torch.zeros_like(a))
                            for a in (cx, cy, cz, cell_idx))
    offs = device_constant(_CORNER_OFF, torch.int64, dev)
    cvals = occ[cz[:, None] + offs[None, :, 2], cy[:, None] + offs[None, :, 1],
                cx[:, None] + offs[None, :, 0]]           # [NC, 8]
    cvals = torch.where(alive[:, None], cvals, torch.zeros_like(cvals))
    return Cells(cx, cy, cz, cell_idx, cvals, n_cells, n_cells_total)


def cells_tile_rows(iw: int) -> int:
    """Rows of ``iw`` cells a tile of :func:`lattice_cells` (whole rows,
    at most ``CELLS_TILE_CELLS`` cells as 32-cell words)."""
    return (CELLS_TILE_CELLS // 32) // -(-iw // 32)


def cells_tiles(scanned_shape: Tuple[int, int, int]) -> int:
    """The tiles of :func:`lattice_cells` over the cells of a grid of
    ``scanned_shape`` (D, H, W) points (the coarse grid, or the fine one
    without it)."""
    D, H, W = scanned_shape
    return -(-((D - 1) * (H - 1)) // cells_tile_rows(W - 1))


def lattice_cells(occ: torch.Tensor, iso: float, max_cells: int,
                  coarse_occ: Optional[torch.Tensor] = None,
                  max_candidates: Optional[int] = None) -> Cells:
    """The active cells of ``occ [D, H, W]`` (float32, any strides).

    With ``coarse_occ`` (``occ`` is its 2x align_corners upsample sliced by
    one) every mixed coarse cell among the first ``(max_candidates or
    max_cells) // 8`` expands into its 8 fine cells, and those exactly
    mixed at fine resolution are kept in that candidate order;
    ``n_cells_total`` adds 8 for each mixed coarse cell past that budget.
    Without it the fine grid's mixed cells, in linear order. The first
    ``max_cells`` are kept (:class:`Cells`; rows past ``n_cells`` are
    zero)."""
    global launches_cells
    if not _on_card(occ):
        return lattice_cells_plain(occ, iso, max_cells, coarse_occ,
                                   max_candidates)
    grids = (occ,) if coarse_occ is None else (occ, coarse_occ)
    for g in grids:
        if g.dtype != torch.float32 or g.ndim != 3 or min(g.shape) < 2 or \
                g.device != occ.device:
            raise ValueError("occ and coarse_occ must be float32 [D, H, W] "
                             "grids on one device, each side at least 2")
    if max_cells < 1:
        raise ValueError(f"max_cells {max_cells}")
    D, H, W = occ.shape
    dev = occ.device
    nc_budget = (max_candidates or max_cells) // 8
    scanned = occ.shape if coarse_occ is None else coarse_occ.shape
    if scanned[2] - 1 > CELLS_TILE_CELLS:
        raise ValueError(f"rows of {scanned[2] - 1} cells: at most "
                         f"{CELLS_TILE_CELLS}")
    if coarse_occ is None:
        cptr, cshape, cstr = None, (0, 0, 0), None
    else:
        cptr, cshape = coarse_occ.data_ptr(), coarse_occ.shape
        cstr = (ctypes.c_longlong * 3)(*coarse_occ.stride())
    fstr = (ctypes.c_longlong * 3)(*occ.stride())
    scratch = torch.empty((2 + cells_tiles(scanned),), dtype=torch.int64,
                          device=dev)
    out = torch.empty((8 * max_cells,), dtype=torch.int64, device=dev)
    counts = torch.empty((2,), dtype=torch.int64, device=dev)
    lib = _lib_on(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib, lib.icon_lattice_cells(
            occ.data_ptr(), D, H, W, fstr, cptr, *cshape, cstr, float(iso),
            nc_budget, max_cells, out.data_ptr(), counts.data_ptr(),
            scratch.data_ptr(), stream), "icon_lattice_cells")
    launches_cells += 1
    mc = max_cells
    return Cells(out[:mc], out[mc:2 * mc], out[2 * mc:3 * mc],
                 out[3 * mc:4 * mc],
                 out[4 * mc:].view(torch.float32).view(mc, 8),
                 counts[0], counts[1])


# --- lattice_emit ------------------------------------------------------------

def _n_sum(grid_shape: Tuple[int, int, int]) -> int:
    """Summary words of the edge-id bitmap of a grid (D, H, W): a bit a
    bitmap word, 1024 ids a summary word."""
    D, H, W = grid_shape
    return max(1, -(-(D * H * W * 8) // 1024))


def lattice_emit_plain(cvals: torch.Tensor, cx: torch.Tensor,
                       cy: torch.Tensor, cz: torch.Tensor,
                       cell_idx: torch.Tensor, n_cells: torch.Tensor,
                       n_cells_total: torch.Tensor,
                       fine_shape: Tuple[int, int, int], iso: float,
                       max_verts: int) -> LatticeOut:
    """See :func:`lattice_emit`."""
    D, H, W = fine_shape
    cw, ch = W - 1, H - 1
    dev = cvals.device
    max_cells = cx.shape[0]
    alive = torch.arange(max_cells, device=dev) < n_cells
    cbits = (cvals > iso).to(torch.int32)

    slots = device_constant(_EDGE_SLOTS, torch.int64, dev)
    v_lo = cvals[:, slots[:, 0]]                          # [NC, 19]
    v_hi = cvals[:, slots[:, 1]]
    crossing = (v_lo > iso) != (v_hi > iso)
    olo = device_constant(_CORNER_OFF[_EDGE_SLOTS[:, 0]], torch.int64,
                          dev)                            # [19, 3] (x, y, z)
    own = (((olo[None, :, 0] == 0) | (cx[:, None] == cw - 1)) &
           ((olo[None, :, 1] == 0) | (cy[:, None] == ch - 1)) &
           ((olo[None, :, 2] == 0) | (cz[:, None] == D - 2)))
    valid = crossing & own & alive[:, None]

    denom = v_hi - v_lo
    s = torch.clamp((iso - v_lo) / torch.where(denom == 0,
                                               torch.ones_like(denom), denom),
                    0.0, 1.0)
    plin = ((cz[:, None] + olo[None, :, 2]) * H +
            (cy[:, None] + olo[None, :, 1])) * W + \
        (cx[:, None] + olo[None, :, 0])
    eid = plin * 8 + slots[None, :, 2]                    # [NC, 19] int64

    vpos, n_verts, n_verts_total = _compact(valid.reshape(-1), max_verts)
    live = torch.arange(max_verts, device=dev) < n_verts
    # canonical wire order: ascending edge id; dead slots sort to the tail
    vert_eid = torch.where(live, eid.reshape(-1)[vpos],
                           torch.full_like(vpos, INT64_MAX))
    vert_s = torch.where(live, s.reshape(-1)[vpos],
                         torch.zeros((), dtype=s.dtype, device=dev))
    vert_eid, order = torch.sort(vert_eid, stable=True)
    vert_s = vert_s[order]

    weights = device_constant([1, 2, 4, 8, 16, 32, 64, 128], torch.int32,
                              dev)
    cbyte = torch.where(alive, (cbits * weights).sum(-1, dtype=torch.int32),
                        torch.zeros((), dtype=torch.int32, device=dev))
    return LatticeOut(vert_eid, vert_s, cell_idx, cbyte,
                      torch.clamp(n_verts, max=max_verts),
                      torch.clamp(n_cells, max=max_cells),
                      n_verts_total, n_cells_total, (D, H, W))


def lattice_emit(cvals: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                 cz: torch.Tensor, cell_idx: torch.Tensor,
                 n_cells: torch.Tensor, n_cells_total: torch.Tensor,
                 fine_shape: Tuple[int, int, int], iso: float,
                 max_verts: int) -> LatticeOut:
    """The lattice vertices and corner bytes of the cells ``(cx, cy, cz)
    [NC]`` (int64, ids ``cell_idx``, corner values ``cvals [NC, 8]`` f32;
    those at and past ``n_cells``, a 0-d tensor, are dead) of a fine grid
    of ``fine_shape`` (D, H, W).

    Each alive cell owns the crossing edges of its 19 slots (the far ones
    only on the grid's last cells); their (edge id ``plin * 8 + dir``,
    fraction ``clamp((iso - v_lo) / (v_hi - v_lo), 0, 1)``) in (cell,
    slot) order, the first ``max_verts``, sorted by edge id, then
    INT64_MAX and 0. Returns a :class:`LatticeOut` (``n_cells_total``
    passed through; dead corner bytes 0)."""
    global launches_emit
    if not _on_card(cvals):
        return lattice_emit_plain(cvals, cx, cy, cz, cell_idx, n_cells,
                                  n_cells_total, fine_shape, iso, max_verts)
    nc = cx.shape[0]
    dev = cvals.device
    if cvals.dtype != torch.float32 or tuple(cvals.shape) != (nc, 8):
        raise ValueError("cvals must be float32 [NC, 8]")
    for t in (cx, cy, cz, n_cells):
        if t.dtype != torch.int64 or t.device != dev:
            raise TypeError("cell coordinates and n_cells must be int64 on "
                            "cvals' device")
    D, H, W = fine_shape
    if nc < 1 or max_verts < 1 or min(fine_shape) < 2:
        raise ValueError(f"{nc} cells, {max_verts} vertices, grid "
                         f"{fine_shape}")
    cvals = cvals.contiguous()
    if cvals.data_ptr() % 16:
        cvals = cvals.clone()
    cx, cy, cz = cx.contiguous(), cy.contiguous(), cz.contiguous()
    n_cells = n_cells.reshape(()).contiguous()
    n_sum = _n_sum(fine_shape)
    rows = min(max_verts, 32 * n_sum)
    blocks, totals = _grid_blocks(dev)
    mv = max_verts
    # vert_eid, keid, word_rank, sum_rank, counts, totals, summary, ks,
    # vert_s, cell_bits
    ws, o = _workspace(dev, (8 * mv, 8 * mv, 8 * rows, 8 * n_sum, 24,
                             totals, 4 * n_sum, 4 * mv, 4 * mv, 4 * nc))
    w32, base = ws.view(torch.int32), ws.data_ptr()
    o32 = [b // 4 for b in o]
    counts = ws[o[4] // 8:o[4] // 8 + 3]    # kept, total, clamped n_cells
    lib = _lib_on(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib, lib.icon_lattice_emit(
            cvals.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
            n_cells.data_ptr(), nc, D, H, W, float(iso), max_verts, n_sum,
            base + o[6], base + o[3], base + o[2], base + o[5], blocks,
            base + o[1], base + o[7], base + o[9], base + o[0], base + o[8],
            base + o[4], stream), "icon_lattice_emit")
    launches_emit += 1
    rank = [w32[o32[6]:o32[6] + n_sum],
            w32[o32[3]:o32[3] + 2 * n_sum].view(n_sum, 2),
            w32[o32[2]:o32[2] + 2 * rows].view(rows, 2)]
    vert_s = ws.view(torch.float32)[o32[8]:o32[8] + mv]
    return LatticeOut(ws[:mv], vert_s, cell_idx, w32[o32[9]:o32[9] + nc],
                      counts[0], counts[2], counts[1], n_cells_total,
                      (D, H, W), rank)


# --- lattice_decode ----------------------------------------------------------

def _popc32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64 of ``x``."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def rank_tables_plain(vert_eid: torch.Tensor, n_verts,
                      grid_shape: Tuple[int, int, int]) -> list:
    """The rank tables that ``lattice_emit`` leaves on the card for the
    decode, from its sorted ids (the first ``n_verts`` live):
    [summary [n_sum] (bit b of word s: the ids of 32-id word 32 s + b
    hold one), sum_rank [n_sum, 2] (touched words before summary word s,
    its bits), word_rank [touched words, 2] (ids before the word, its
    bits)], all int64 holding u32 bits. On the card they are int32 views
    of the emit's workspace, and sum_rank's rows of untouched summary
    words are neither written nor read (here (touched words before,
    0))."""
    n_sum = _n_sum(grid_shape)
    dev = vert_eid.device
    ids = vert_eid[:max(0, min(int(n_verts), vert_eid.shape[0]))]
    words, inv = torch.unique(ids >> 5, sorted=True, return_inverse=True)
    bits = torch.zeros(words.shape[0], dtype=torch.int64, device=dev)
    bits.index_put_((inv,), torch.ones_like(ids) << (ids & 31),
                    accumulate=True)                  # distinct ids: OR
    word_rank = torch.stack([torch.cumsum(_popc32(bits), 0) - _popc32(bits),
                             bits], -1)
    summary = torch.zeros(n_sum, dtype=torch.int64, device=dev)
    summary.index_put_((words >> 5,),
                       torch.ones_like(words) << (words & 31),
                       accumulate=True)                # distinct words
    touched = _popc32(summary)
    sum_rank = torch.stack([torch.cumsum(touched, 0) - touched, summary], -1)
    return [summary, sum_rank, word_rank]


def rank_lookup_plain(tables: list, keys: torch.Tensor) -> torch.Tensor:
    """The rank of each edge id of ``keys`` among the kept ids, or -1
    where it is none, as the decode kernel looks it up in ``tables``
    (:func:`rank_tables_plain`): two dependent reads, the summary word's
    row, then the bitmap word's."""
    summary, sum_rank, word_rank = tables
    n_ids = summary.shape[0] * 1024
    ok = (keys >= 0) & (keys < n_ids)
    e = torch.where(ok, keys, torch.zeros_like(keys))
    w = e >> 5
    sw = summary[w >> 5]
    below_w = (torch.ones_like(w) << (w & 31)) - 1
    ok = ok & (((sw >> (w & 31)) & 1) == 1)
    k = sum_rank[w >> 5, 0] + _popc32(sw & below_w)
    # an id that is none reads a zero row past the table's end
    rows = torch.cat([word_rank, word_rank.new_zeros((1, 2))])
    wr = rows[torch.where(ok, k, torch.full_like(k, word_rank.shape[0]))]
    ok = ok & (((wr[..., 1] >> (e & 31)) & 1) == 1)
    below_e = (torch.ones_like(e) << (e & 31)) - 1
    r = wr[..., 0] + _popc32(wr[..., 1] & below_e)
    return torch.where(ok, r, torch.full_like(r, -1))


def release_rank(out: LatticeOut) -> None:
    """Drop ``out``'s rank tables (views of its emit's workspace, which
    lives as long as ``out``'s outputs); a later decode of ``out`` builds
    them anew."""
    if out.rank:
        out.rank.clear()


def _rank_tables(out: LatticeOut, lib) -> list:
    """The rank tables of ``out``'s live ids on the card
    (``icon_lattice_rank``: one cooperative launch of the emit's rank
    phases), views of one workspace."""
    dev = out.vert_eid.device
    n_sum = _n_sum(out.grid_shape)
    cap = out.vert_eid.shape[0]
    rows = min(cap, 32 * n_sum)
    blocks, totals = _grid_blocks(dev)
    # word_rank, sum_rank, totals, summary
    ws, o = _workspace(dev, (8 * rows, 8 * n_sum, totals, 4 * n_sum))
    w32, base = ws.view(torch.int32), ws.data_ptr()
    ids = out.vert_eid.contiguous()
    n = out.n_verts.reshape(()).contiguous()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.icon_lattice_rank(
            ids.data_ptr(), n.data_ptr(), cap, n_sum, base + o[3],
            base + o[1], base + o[0], base + o[2], blocks,
            torch.cuda.current_stream().cuda_stream), "icon_lattice_rank")
    return [w32[o[3] // 4:o[3] // 4 + n_sum],
            w32[o[1] // 4:o[1] // 4 + 2 * n_sum].view(n_sum, 2),
            w32[:2 * rows].view(rows, 2)]


def decode_sizes(out: LatticeOut) -> Tuple[int, int]:
    """The full buffers of :func:`lattice_decode` for ``out``: every vertex
    row, and 12 faces (6 tets x 2) a cell row."""
    return out.vert_eid.shape[0], 12 * out.cell_id.shape[0]


def lattice_decode_plain(out: LatticeOut, nvb: int, nfb: int
                         ) -> torch.Tensor:
    """See :func:`lattice_decode` (reads the counts on the host; the rows
    past the counts are 0)."""
    D, H, W = out.grid_shape
    cw, ch = W - 1, H - 1
    dev = out.vert_eid.device
    nv = max(0, min(int(out.n_verts), out.vert_eid.shape[0]))
    nc = max(0, min(int(out.n_cells), out.cell_id.shape[0]))
    eid = out.vert_eid[:nv]
    q = torch.clamp(torch.round(out.vert_s[:nv] * 255.0), 0, 255)
    # a 0-d tensor divisor: CUDA divides by a host scalar through its
    # reciprocal, which the host decoder's exact division does not
    s = q / q.new_full((), 255.0)
    lo, d = eid >> 3, eid & 7
    verts = torch.stack([
        (lo % W).to(torch.float32) + s * (d & 1).to(torch.float32),
        ((lo // W) % H).to(torch.float32) + s * ((d >> 1) & 1).to(
            torch.float32),
        (lo // (H * W)).to(torch.float32) + s * ((d >> 2) & 1).to(
            torch.float32)], -1)                          # [nv, 3]

    tet_case, tri_lo, tri_dcode, tri_valid = (
        device_constant(t, torch.int64, dev) for t in _host_tables_flat())
    cid = out.cell_id[:nc]
    bits = out.cell_bits[:nc].to(torch.int64) & 0xFF
    cx, cy, cz = cid % cw, (cid // cw) % ch, cid // (cw * ch)
    t6 = torch.arange(6, device=dev)
    e96 = t6 * 16 + tet_case[bits[:, None] * 6 + t6]      # [nc, 6]
    tri = (e96[:, :, None] * 2 + torch.arange(2, device=dev)).reshape(nc, 12)
    slot = tri[:, :, None] * 3 + torch.arange(3, device=dev)  # [nc, 12, 3]
    lo_loc, dc = tri_lo[slot], tri_dcode[slot]
    lin = ((cz[:, None, None] + ((lo_loc >> 2) & 1)) * H +
           (cy[:, None, None] + ((lo_loc >> 1) & 1))) * W + \
        (cx[:, None, None] + (lo_loc & 1))
    key = lin * 8 + dc
    if nv:
        r = torch.searchsorted(eid, key)
        found = (r < nv) & (eid[torch.clamp(r, max=nv - 1)] == key)
    else:
        r, found = torch.zeros_like(key), torch.zeros_like(key,
                                                           dtype=torch.bool)
    ok = (tri_valid[tri] != 0) & found.all(-1) & \
        (r[..., 0] != r[..., 1]) & (r[..., 1] != r[..., 2]) & \
        (r[..., 0] != r[..., 2])
    faces = r[ok].to(torch.int32)                         # (cell, slot) order
    nf = faces.shape[0]

    buf = torch.zeros((HEADER + 3 * nvb + 3 * nfb,), dtype=torch.int32,
                      device=dev)
    buf[:3] = torch.tensor([nv, nf, nc], dtype=torch.int32)
    nw, fw = min(nv, nvb), min(nf, nfb)
    buf[HEADER:HEADER + 3 * nw] = verts[:nw].reshape(-1).view(torch.int32)
    fo = HEADER + 3 * nvb
    buf[fo:fo + 3 * fw] = faces[:fw].reshape(-1)
    return buf


def lattice_decode(out: LatticeOut, nvb: int, nfb: int) -> torch.Tensor:
    """The mesh of ``out`` as the host decoder builds it from the wire v1
    at full size (``csrc/latticecodec.cc:77-150``): vertices in ascending
    edge-id order, ``lo + s8 / 255 * d`` an axis with ``s8 = clamp(rint(s
    * 255), 0, 255)`` as :func:`~icon_tpu_torch.recon.marching.pack_lattice`
    quantizes it; faces cell by cell, tet by tet, slot by slot, a face
    whose edge is no vertex or whose ranks repeat dropped.

    Returns one int32 buffer ``[header 4 | verts 3 nvb f32 | faces 3 nfb
    i32]``: the header (vertices, faces, cells, 0) holds the true counts,
    written on the device, then the first ``nvb`` vertices and ``nfb``
    faces (rows past the counts unspecified on the card).
    :func:`unpack_decoded` reads it."""
    global launches_decode
    if not _on_card(out.vert_eid):
        return lattice_decode_plain(out, nvb, nfb)
    D, H, W = out.grid_shape
    dev = out.vert_eid.device
    nv_cap, nc_cap = out.vert_eid.shape[0], out.cell_id.shape[0]
    if out.vert_eid.dtype != torch.int64 or out.cell_id.dtype != torch.int64 \
            or out.cell_bits.dtype != torch.int32 or \
            out.vert_s.dtype != torch.float32:
        raise TypeError("LatticeOut must hold int64 ids, int32 corner bytes "
                        "and float32 fractions")
    if nvb < 0 or nfb < 0 or min(H, W) < 2:
        raise ValueError(f"sizes {nvb}, {nfb} on grid {out.grid_shape}")
    buf = torch.empty((HEADER + 3 * nvb + 3 * nfb,), dtype=torch.int32,
                      device=dev)
    scratch = torch.empty((1 + -(-nc_cap // DECODE_TILE_CELLS),),
                          dtype=torch.int64, device=dev)
    ts = [t.contiguous() for t in (out.vert_eid, out.vert_s, out.n_verts,
                                   out.cell_id, out.cell_bits, out.n_cells)]
    lib = _lib_on(dev)
    rank = out.rank or _rank_tables(out, lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib, lib.icon_lattice_decode(
            ts[0].data_ptr(), ts[1].data_ptr(), ts[2].data_ptr(), nv_cap,
            ts[3].data_ptr(), ts[4].data_ptr(), ts[5].data_ptr(), nc_cap, H,
            W, _n_sum(out.grid_shape), *(t.data_ptr() for t in rank), nvb,
            nfb, buf.data_ptr(), scratch.data_ptr(), stream),
            "icon_lattice_decode")
    launches_decode += 1
    return buf


def unpack_decoded(buf, nvb: int, nfb: int
                   ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(verts [V, 3] f32, faces [F, 3] int64, overflow) of a
    :func:`lattice_decode` buffer on the host (a numpy array or a CPU
    tensor); the overflow flag is set when the true counts exceed ``nvb``
    or ``nfb`` (the mesh is then truncated: decode again with the header's
    counts)."""
    host = buf.numpy() if torch.is_tensor(buf) else np.asarray(buf)
    nv, nf = int(host[0]), int(host[1])
    nw, fw = min(nv, nvb), min(nf, nfb)
    verts = host[HEADER:HEADER + 3 * nw].view(np.float32).reshape(nw, 3)
    fo = HEADER + 3 * nvb
    faces = host[fo:fo + 3 * fw].reshape(fw, 3).astype(np.int64)
    return verts.copy(), faces, nv > nvb or nf > nfb
