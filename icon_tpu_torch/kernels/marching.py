"""The indexed marcher's triangle emit and vertex indexing: the CUDA
kernels and their plain twins.

:func:`mt_emit` and :func:`mt_index` are the wrappers
``recon/marching.py:marching_tetrahedra_indexed`` calls. A CUDA tensor
launches ``csrc/marching.cu`` or raises; a CPU tensor takes the plain
version (:func:`mt_emit_plain`, :func:`mt_index_plain`: the JAX function
in PyTorch, with table gathers in place of its one-hot matmuls and a
stable ``torch.sort`` in place of ``lax.sort``).

- ``mt_emit``: for each active cell, its 6 tets' cases and their valid
  triangle slots; the triangles in linear (cell, slot) order, the first
  ``max_tris`` kept; for each triangle's 3 vertex slots the point on its
  lattice edge and the edge's int64 id ``min(lin_a, lin_b) * 8 + dir``.
  The kernel is one launch: a single-pass scan over tiles of
  ``EMIT_TILE_CELLS`` cells.
- ``mt_index``: each vertex slot's rank among the distinct edge ids (its
  face index) and the vertex table in ascending edge-id order. The kernel
  ranks by a bitmap of the grid's edge ids, its summary (a bit a bitmap
  word) and prefix popcounts, with no sort; only the summary is read
  whole, and only the bitmap words of live ids are cleared and read.

Each call's buffers are its own: the wrappers allocate them from the
caching allocator, and the C entries zero the scan scratch and the summary
(D H W / 32 bytes, 0.52 MB at 256^3 cells and 4.2 MB at 512^3) with
``cudaMemsetAsync`` on the call's stream before the first launch; the
bitmap may hold anything. So two host threads whose calls interleave their
launches on one stream share no state (``mt_index`` is four launches from
one ctypes call, which releases the GIL). Everything goes back to the
allocator after the call.

``launches_emit`` and ``launches_index`` count the wrappers' launches (a
call is one count for its launches).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from icon_tpu_torch.recon.engine import _compact
from icon_tpu_torch.recon.lattice_host import _CORNER_OFF, _TETS, _tet_tables

INT64_MAX = 2 ** 63 - 1
EMIT_TILE_CELLS = 128   # csrc/marching.cu's kTileCells
SCAN_TILE_WORDS = 256   # summary words a tile of mt_index's scan (kThreads)

launches_emit = 0       # mt_emit calls on the card since the last reset
launches_index = 0      # mt_index calls on the card since the last reset

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tables_on = set()      # device indices whose constant tables are set


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["marching.cu"])
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.icon_mt_set_tables.argtypes = [vp, vp, vp]
            lib.icon_mt_emit.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, ci,
                                         ctypes.c_float, cl, vp, vp, vp, vp,
                                         vp, vp, vp]
            lib.icon_mt_index.argtypes = [vp, vp, vp, vp, vp, cl, cl, vp, vp,
                                          vp, vp, vp, cl, vp, vp, vp, vp, vp,
                                          vp]
            lib.icon_mt_error_string.argtypes = [ci]
            lib.icon_mt_error_string.restype = ctypes.c_char_p
            for fn in (lib.icon_mt_emit_tile_cells,
                       lib.icon_mt_index_tile_words):
                fn.argtypes = []
            for fn in (lib.icon_mt_set_tables, lib.icon_mt_emit,
                       lib.icon_mt_index, lib.icon_mt_emit_tile_cells,
                       lib.icon_mt_index_tile_words):
                fn.restype = ci
            if (lib.icon_mt_emit_tile_cells(),
                    lib.icon_mt_index_tile_words()) != (EMIT_TILE_CELLS,
                                                        SCAN_TILE_WORDS):
                raise RuntimeError("csrc/marching.cu's tile sizes differ "
                                   "from kernels/marching.py's")
            _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.icon_mt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _lib_on(device: torch.device) -> ctypes.CDLL:
    """The library, with its (tet, case) tables in ``device``'s constant
    memory."""
    lib = _load()
    with _lock:
        if device.index not in _tables_on:
            A, B, valid = (np.ascontiguousarray(x, dtype=np.uint8)
                           for x in _tet_tables())
            with torch.cuda.device(device):
                _raise_on(lib, lib.icon_mt_set_tables(
                    A.ctypes.data, B.ctypes.data, valid.ctypes.data),
                    "icon_mt_set_tables")
            _tables_on.add(device.index)
    return lib


def _tables_on_device(device):
    """(tets [6, 4], A, B [6, 16, 2, 3], valid [6, 16, 2], corner offsets
    [8, 3]) as tensors on ``device``."""
    A, B, valid = _tet_tables()
    return (torch.as_tensor(_TETS, dtype=torch.int64, device=device),
            torch.as_tensor(A, dtype=torch.int64, device=device),
            torch.as_tensor(B, dtype=torch.int64, device=device),
            torch.as_tensor(valid, device=device),
            torch.as_tensor(_CORNER_OFF, dtype=torch.int64, device=device))


def mt_emit_plain(occ: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  cz: torch.Tensor, n_cells: torch.Tensor, iso: float,
                  max_tris: int):
    """See :func:`mt_emit`."""
    D, H, W = occ.shape
    dev = occ.device
    nc = cx.shape[0]
    tets, A, B, valid, offs = _tables_on_device(dev)
    lin = ((cz[:, None] + offs[None, :, 2]) * H +
           (cy[:, None] + offs[None, :, 1])) * W + \
        (cx[:, None] + offs[None, :, 0])
    cvals = occ.reshape(-1)[lin]                          # [NC, 8]
    cbits = (cvals > iso).to(torch.int64)
    case = (cbits[:, tets] * torch.tensor([1, 2, 4, 8], device=dev)).sum(-1)
    t6 = torch.arange(6, device=dev)[None]
    a = A[t6, case].reshape(nc, 36)         # slot order (tet, tri, vert)
    b = B[t6, case].reshape(nc, 36)
    slot_valid = valid[t6, case].reshape(nc, 12)

    va = torch.gather(cvals, 1, a)
    vb = torch.gather(cvals, 1, b)
    denom = vb - va
    t = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 0.5),
                    (iso - va) / denom)
    t = torch.clamp(t, 0.0, 1.0)                          # [NC, 36]
    oa, ob = offs[a], offs[b]                             # [NC, 36, 3]
    base = torch.stack([cx, cy, cz], -1)[:, None]         # [NC, 1, 3]
    ga, gb = base + oa, base + ob
    pts = ga.to(occ.dtype) + t[..., None] * (ob - oa).to(occ.dtype)
    a_lin = (ga[..., 2] * H + ga[..., 1]) * W + ga[..., 0]
    b_lin = (gb[..., 2] * H + gb[..., 1]) * W + gb[..., 0]
    d = (ob - oa).abs()
    edge_id = torch.minimum(a_lin, b_lin) * 8 + d[..., 0] + 2 * d[..., 1] + \
        4 * d[..., 2]                                     # [NC, 36]

    alive = torch.arange(nc, device=dev) < n_cells
    tri_idx, n_tris, n_total = _compact(
        (slot_valid & alive[:, None]).reshape(-1), max_tris)
    tri_alive = torch.arange(max_tris, device=dev) < n_tris
    tp = pts.reshape(nc * 12, 3, 3)[tri_idx]              # [mt, 3, 3]
    teid = edge_id.reshape(nc * 12, 3)[tri_idx]
    teid = torch.where(tri_alive[:, None], teid,
                       torch.full_like(teid, INT64_MAX))
    return tp[..., 0], tp[..., 1], tp[..., 2], teid, n_tris, n_total


def mt_emit(occ: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
            cz: torch.Tensor, n_cells: torch.Tensor, iso: float,
            max_tris: int):
    """Triangles of the active cells ``(cx, cy, cz) [NC]`` (int64; those at
    and past ``n_cells``, a 0-d tensor, are dead) of ``occ [D, H, W]``.

    Returns (tvx, tvy, tvz [max_tris, 3] f32: each vertex slot's point in
    grid coordinates; teid [max_tris, 3] int64 edge ids, INT64_MAX past
    the live triangles; n_tris = min(total, max_tris); n_total), the
    counts 0-d int64 tensors. Triangles are in linear (cell, slot) order;
    the coordinates of dead rows are unspecified."""
    global launches_emit
    if occ.device.type == "cpu":
        return mt_emit_plain(occ, cx, cy, cz, n_cells, iso, max_tris)
    if occ.device.type != "cuda":
        raise ValueError(f"unsupported device {occ.device}")
    if occ.dtype != torch.float32 or not occ.is_contiguous() or \
            occ.ndim != 3 or min(occ.shape) < 2:
        raise ValueError("occ must be a contiguous float32 [D, H, W] grid, "
                         "each side at least 2")
    for t in (cx, cy, cz, n_cells):
        if t.dtype != torch.int64 or t.device != occ.device:
            raise TypeError("cell coordinates and n_cells must be int64 on "
                            "the grid's device")
    nc = cx.shape[0]
    if nc < 1 or nc >= 2 ** 31 or max_tris < 1:
        raise ValueError(f"{nc} cells, {max_tris} triangles")
    dev = occ.device
    cx, cy, cz = cx.contiguous(), cy.contiguous(), cz.contiguous()
    n_cells = n_cells.reshape(()).contiguous()
    bufs = emit_buffers(nc, max_tris, dev)
    _emit_launch(occ, cx, cy, cz, n_cells, iso, max_tris, bufs)
    launches_emit += 1
    tv = bufs.tv
    return tv[0], tv[1], tv[2], bufs.teid, \
        torch.clamp(bufs.n_total, max=max_tris), bufs.n_total


class EmitBuffers(NamedTuple):
    """mt_emit's buffers: ``scan`` [emit_scratch_words(nc)] int64, the
    scan's ticket and tile statuses (zeroed by the C entry); ``tv``
    [3, max_tris, 3] f32 (rows past the total unspecified); ``teid``
    [max_tris, 3] int64 filled with INT64_MAX; ``n_total``."""
    scan: torch.Tensor
    tv: torch.Tensor
    teid: torch.Tensor
    n_total: torch.Tensor


def emit_scratch_words(nc: int) -> int:
    """The int64 words of mt_emit's scan scratch for ``nc`` cells: the
    ticket and a status a tile of EMIT_TILE_CELLS."""
    return 1 + -(-nc // EMIT_TILE_CELLS)


def _emit_outputs(max_tris: int, device):
    return (torch.empty((3, max_tris, 3), dtype=torch.float32,
                        device=device),
            torch.full((max_tris, 3), INT64_MAX, dtype=torch.int64,
                       device=device),
            torch.empty((), dtype=torch.int64, device=device))


def emit_buffers(nc: int, max_tris: int, device) -> EmitBuffers:
    """mt_emit's buffers for ``nc`` cells on ``device``
    (:class:`EmitBuffers`); they serve any number of launches in stream
    order."""
    return EmitBuffers(torch.empty((emit_scratch_words(nc),),
                                   dtype=torch.int64, device=device),
                       *_emit_outputs(max_tris, device))


def _emit_launch(occ, cx, cy, cz, n_cells, iso, max_tris,
                 bufs: EmitBuffers) -> None:
    """mt_emit's launch on caller-owned buffers (:func:`emit_buffers`,
    inputs checked by the caller) on the current stream; counts nothing.
    :func:`mt_emit` and the kernel's timing use it."""
    lib = _lib_on(occ.device)
    D, H, W = occ.shape
    tv = bufs.tv
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib, lib.icon_mt_emit(
            occ.data_ptr(), D, H, W, cx.data_ptr(), cy.data_ptr(),
            cz.data_ptr(), n_cells.data_ptr(), cx.shape[0], float(iso),
            max_tris, bufs.scan.data_ptr(), tv[0].data_ptr(),
            tv[1].data_ptr(), tv[2].data_ptr(), bufs.teid.data_ptr(),
            bufs.n_total.data_ptr(), stream), "icon_mt_emit")


def mt_index_plain(tvx: torch.Tensor, tvy: torch.Tensor, tvz: torch.Tensor,
                   teid: torch.Tensor, n_tris: torch.Tensor, max_verts: int,
                   grid_shape: Tuple[int, int, int]):
    """See :func:`mt_index`."""
    dev = teid.device
    max_tris = teid.shape[0]
    keys = teid.reshape(-1)
    sk, order = torch.sort(keys, stable=True)
    sx = tvx.reshape(-1)[order]
    sy = tvy.reshape(-1)[order]
    sz = tvz.reshape(-1)[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sk[1:] != sk[:-1]]) & (sk != INT64_MAX)
    vid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
    n_unique = torch.clamp(vid_sorted[-1] + 1, min=0)
    vpos, _, _ = _compact(first, max_verts)
    soup_vid = torch.zeros_like(vid_sorted).scatter_(0, order, vid_sorted)
    faces = soup_vid.reshape(-1, 3).to(torch.int32)
    tri_alive = torch.arange(max_tris, device=dev) < n_tris
    faces = torch.where(tri_alive[:, None], faces, torch.zeros_like(faces))
    return sx[vpos], sy[vpos], sz[vpos], faces, n_unique


def mt_index(tvx: torch.Tensor, tvy: torch.Tensor, tvz: torch.Tensor,
             teid: torch.Tensor, n_tris: torch.Tensor, max_verts: int,
             grid_shape: Tuple[int, int, int]):
    """Dedup :func:`mt_emit`'s vertex slots by edge id, on ``grid_shape``
    (D, H, W), the marched grid's.

    Returns (vx, vy, vz [max_verts] f32: the distinct vertices in ascending
    edge-id order, rows past the count unspecified; faces [max_tris, 3]
    int32: each slot's rank, 0 past the live triangles; n_unique, a 0-d
    int64 tensor, the distinct count before the max_verts cut)."""
    global launches_index
    if teid.device.type == "cpu":
        return mt_index_plain(tvx, tvy, tvz, teid, n_tris, max_verts,
                              grid_shape)
    if teid.device.type != "cuda":
        raise ValueError(f"unsupported device {teid.device}")
    dev = teid.device
    max_tris = teid.shape[0]
    for t in (tvx, tvy, tvz):
        if t.dtype != torch.float32 or t.shape != teid.shape or \
                t.device != dev:
            raise ValueError("vertex slots must be float32 like teid")
    if teid.dtype != torch.int64 or n_tris.dtype != torch.int64:
        raise TypeError("teid and n_tris must be int64")
    if 3 * max_tris >= 2 ** 31 or max_verts < 1:
        raise ValueError(f"{max_tris} triangles, {max_verts} vertices")
    tvx, tvy, tvz = (t.contiguous() for t in (tvx, tvy, tvz))
    bufs = index_buffers(max_tris, max_verts, grid_shape, dev)
    _index_launch(tvx, tvy, tvz, teid.contiguous(),
                  n_tris.reshape(()).contiguous(), max_verts, bufs)
    launches_index += 1
    verts = bufs.verts
    return verts[0], verts[1], verts[2], bufs.faces, bufs.n_unique


class IndexBuffers(NamedTuple):
    """mt_index's buffers (sizes from :func:`index_sizes`): ``bitmap``
    int32, a bit an edge id (any contents); ``summary`` int32, a bit a
    bitmap word, and the scan's ``scan`` int64, both zeroed by the C entry;
    ``sum_rank`` [summary, 2] and ``word_rank`` [touched, 2] int32
    scratch; ``verts`` [3, max_verts] f32 (rows past the count
    unspecified); ``faces`` [max_tris, 3] int32; ``n_unique``."""
    bitmap: torch.Tensor
    summary: torch.Tensor
    scan: torch.Tensor
    sum_rank: torch.Tensor
    word_rank: torch.Tensor
    verts: torch.Tensor
    faces: torch.Tensor
    n_unique: torch.Tensor


def index_sizes(max_tris: int, grid_shape: Tuple[int, int, int]) -> dict:
    """mt_index's buffer sizes in elements on a (D, H, W) grid: the
    summary's int32 words (a bit for each 32 edge ids' bitmap word, D H W
    8 / 1024 words), the bitmap's (32 a summary word), the scan's int64
    words (the ticket, a status a tile of SCAN_TILE_WORDS) and the
    touched bitmap words' ranks (at most a live slot each)."""
    D, H, W = grid_shape
    summary = max(1, -(-(D * H * W * 8) // 1024))
    return {"summary": summary, "bitmap": 32 * summary,
            "scan": 1 + -(-summary // SCAN_TILE_WORDS),
            "touched": min(3 * max_tris, 32 * summary)}


def _index_outputs(sz: dict, max_tris: int, max_verts: int, device):
    return (torch.empty((sz["summary"], 2), dtype=torch.int32,
                        device=device),
            torch.empty((sz["touched"], 2), dtype=torch.int32,
                        device=device),
            torch.empty((3, max_verts), dtype=torch.float32, device=device),
            torch.empty((max_tris, 3), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.int64, device=device))


def index_buffers(max_tris: int, max_verts: int,
                  grid_shape: Tuple[int, int, int], device) -> IndexBuffers:
    """mt_index's buffers on ``device`` (:class:`IndexBuffers`); they
    serve any number of launches in stream order."""
    sz = index_sizes(max_tris, grid_shape)
    return IndexBuffers(
        torch.empty((sz["bitmap"],), dtype=torch.int32, device=device),
        torch.empty((sz["summary"],), dtype=torch.int32, device=device),
        torch.empty((sz["scan"],), dtype=torch.int64, device=device),
        *_index_outputs(sz, max_tris, max_verts, device))


def _index_launch(tvx, tvy, tvz, teid, n_tris, max_verts,
                  bufs: IndexBuffers) -> None:
    """mt_index's launches on caller-owned buffers (:func:`index_buffers`,
    inputs checked by the caller) on the current stream; counts nothing.
    :func:`mt_index` and the kernel's timing use it."""
    lib = _lib_on(teid.device)
    v = bufs.verts
    with torch.cuda.device(teid.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib, lib.icon_mt_index(
            teid.data_ptr(), tvx.data_ptr(), tvy.data_ptr(), tvz.data_ptr(),
            n_tris.data_ptr(), teid.numel(), bufs.summary.numel(),
            bufs.bitmap.data_ptr(), bufs.summary.data_ptr(),
            bufs.scan.data_ptr(), bufs.sum_rank.data_ptr(),
            bufs.word_rank.data_ptr(), max_verts, bufs.faces.data_ptr(),
            v[0].data_ptr(), v[1].data_ptr(), v[2].data_ptr(),
            bufs.n_unique.data_ptr(), stream), "icon_mt_index")

