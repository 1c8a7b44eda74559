"""The recon engine's level step: the CUDA kernels and their plain twins.

The engine (``recon/engine.py``) calls four wrappers. A CUDA tensor
launches ``csrc/level.cu`` on the current stream or raises; a CPU tensor
takes the plain twin, the engine's torch code:

- :func:`upsample`: the 2x trilinear align_corners upsample (r -> 2r - 1)
  of the faster mode's last level; one launch of ``level_upsample``.
- :func:`level_select`: a level's marks and compaction: the fine
  occupancy, the fine evaluated flags, the dilated boundary minus the
  evaluated voxels, its first ``budget`` indices with their query points
  and the counts (n_sel, total, overflow); ``level_upsample`` with marks,
  ``level_mark``, ``level_compact``. Plain twin :func:`level_select_plain`.
- :func:`compact`: the first ``budget`` set voxels of a bool grid, with
  points and counts (exact mode's conflict rounds); ``level_mark`` in byte
  mode, ``level_compact``. Plain twin :func:`compact_points_plain`.
- :func:`level_write`: the queried values and the evaluated flags at the
  live slots; ``level_write``, in place on the card. Plain twin
  :func:`write_plain`.

Each kernel also has a twin of its own output, in the kernels' packed
layout (a grid row of r voxels in ``W = ceil(r / 32)`` 32-bit words, bit b
of word w the voxel x = 32 w + b; one block count a 256 words):
:func:`upsample_marks_plain`, :func:`mark_plain`, :func:`pack_plain`,
:func:`compact_words_plain`; the launches alone, which count nothing, are
``_upsample``, ``_upsample_marks``, ``_mark``, ``_pack``,
``_compact_words`` and ``_write``. ``launches_*`` count each kernel's
launches by the wrappers, so a run can show that the main path went
through them; a CUDA graph's replay counts none.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
from icon_tpu_torch.ops.voxelize import smooth_conv3d

B_MIN = (-1.0, 1.0, -1.0)      # the engine's world box (y flipped)
B_MAX = (1.0, -1.0, 1.0)
BALANCE = 0.5                  # the occupancy iso level
THREADS = 256                  # words a block count covers
MARK_DILATE, MARK_BYTES = 0, 1

launches_upsample = 0          # launches since the last reset, by kernel
launches_mark = 0
launches_compact = 0
launches_write = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["level.cu"])
            vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
            lib.icon_level_upsample.argtypes = [vp, vp, ci, vp, vp, vp, vp]
            lib.icon_level_mark.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp,
                                            vp]
            lib.icon_level_compact.argtypes = [vp, vp, ci, cl, cf, cf, cf,
                                               cf, cf, cf, vp, vp, vp, vp]
            lib.icon_level_write.argtypes = [vp, vp, vp, vp, vp, cl, vp]
            for fn in (lib.icon_level_upsample, lib.icon_level_mark,
                       lib.icon_level_compact, lib.icon_level_write):
                fn.restype = ci
            lib.icon_level_error_string.argtypes = [ci]
            lib.icon_level_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.icon_level_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def words_a_row(r: int) -> int:
    return -(-r // 32)


def n_blocks(r: int) -> int:
    """Block counts of an r^3 grid's words."""
    return -(-(r * r * words_a_row(r)) // THREADS)


# ----------------------------------------------------------------------
# the plain twins: the engine's torch code


def upsample_plain(occ: torch.Tensor) -> torch.Tensor:
    """The 2x trilinear align_corners upsample of ``occ [rc, rc, rc]`` to
    ``[2 rc - 1]^3`` (D, then H, then W midpoints, as the JAX package)."""
    r = 2 * occ.shape[0] - 1
    return resize3d_trilinear_align_corners(occ[None, None], (r, r, r))[0, 0]


def fine_evaluated_plain(ev_c: torch.Tensor) -> torch.Tensor:
    """The coarse flags at fine (2i, 2j, 2k), else False."""
    r = 2 * ev_c.shape[0] - 1
    ev = torch.zeros((r, r, r), dtype=torch.bool, device=ev_c.device)
    ev[::2, ::2, ::2] = ev_c
    return ev


def mixed_plain(occ_c: torch.Tensor) -> torch.Tensor:
    """Fine voxels whose upsampled > 0.5 indicator lies strictly between 0
    and 1."""
    valid = upsample_plain((occ_c > BALANCE).to(torch.float32))
    return (valid > 0.0) & (valid < 1.0)


def compact_plain(mask_flat: torch.Tensor, budget: int):
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


def grid_to_world(coords01: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] grid space (x, y, z) -> world (align_corners)."""
    bmin = device_constant(B_MIN, coords01.dtype, coords01.device)
    bmax = device_constant(B_MAX, coords01.dtype, coords01.device)
    return coords01 * (bmax - bmin) + bmin


def grid_points_plain(idx: torch.Tensor, r: int) -> torch.Tensor:
    """World points [N, 3] of linear indices ``idx`` of an r^3 grid: (x, y,
    z) / (r - 1), a true division (a tensor divisor: a CUDA tensor divided
    by a Python scalar is multiplied by its reciprocal instead)."""
    cz = idx // (r * r)
    cy = (idx // r) % r
    cx = idx % r
    pts01 = torch.stack([cx, cy, cz], -1).to(torch.float32) / \
        device_constant(float(r - 1), torch.float32, idx.device)
    return grid_to_world(pts01)


def _counts(n_sel, total, budget: int) -> torch.Tensor:
    return torch.stack([n_sel, total, torch.clamp(total - budget, min=0)])


def compact_points_plain(mask: torch.Tensor, budget: int):
    """(idx [budget] int64, points [budget, 3], counts [3] int64 = (n_sel,
    total, overflow)) of a bool grid ``mask [r, r, r]``."""
    r = mask.shape[0]
    idx, n_sel, total = compact_plain(mask.reshape(-1), budget)
    return idx, grid_points_plain(idx, r), _counts(n_sel, total, budget)


def level_select_plain(occ_c: torch.Tensor, ev_c: torch.Tensor, k: int,
                       budget: int):
    """(occ_f, ev_f, idx, points, counts) of a level: the upsampled
    occupancy, the coarse flags at (2i, 2j, 2k), and the first ``budget``
    voxels of the k^3-dilated boundary (:func:`mixed_plain`, as the JAX
    package's ``smooth_conv3d(b, k) > 0``) minus those flags, with their
    points and counts."""
    occ_f = upsample_plain(occ_c)
    boundary = smooth_conv3d(mixed_plain(occ_c).to(torch.float32), k) > 0
    ev_f = fine_evaluated_plain(ev_c)
    idx, pts, counts = compact_points_plain(boundary & ~ev_f, budget)
    return occ_f, ev_f, idx, pts, counts


def _set_dropped(flat: torch.Tensor, idx: torch.Tensor,
                 vals) -> torch.Tensor:
    """``flat[idx] = vals`` where idx == len(flat) means "drop": writes into
    a buffer one longer and slices the extra slot off."""
    buf = torch.cat([flat, flat.new_zeros(1)])
    buf[idx] = vals if torch.is_tensor(vals) else buf.new_full((), vals)
    return buf[:-1]


def write_plain(occ: torch.Tensor, ev: torch.Tensor, idx: torch.Tensor,
                counts: torch.Tensor, vals: torch.Tensor):
    """(occ, ev) with ``vals`` and True written at the live slots' indices
    (slot < counts[0]); new tensors."""
    r = occ.shape[0]
    alive = torch.arange(len(idx), device=idx.device) < counts[0]
    safe = torch.where(alive, idx, torch.full_like(idx, r ** 3))
    occ = _set_dropped(occ.reshape(-1), safe, vals).reshape(occ.shape)
    ev = _set_dropped(ev.reshape(-1), safe, True).reshape(ev.shape)
    return occ, ev


# the twins of each kernel's own output, in the packed layout


def pack_rows(mask: torch.Tensor) -> torch.Tensor:
    """A bool grid [r, r, r] as int32 words [r * r, W]."""
    r = mask.shape[0]
    W = words_a_row(r)
    bits = torch.zeros((r * r, 32 * W), dtype=torch.int64,
                       device=mask.device)
    bits[:, :r] = mask.reshape(r * r, r).to(torch.int64)
    shift = torch.arange(32, device=mask.device, dtype=torch.int64)
    words = (bits.reshape(r * r, W, 32) << shift).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_rows(words: torch.Tensor, r: int) -> torch.Tensor:
    """int32 words [r * r, W] as a bool grid [r, r, r]."""
    shift = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shift) & 1
    return bits.reshape(r * r, -1)[:, :r].reshape(r, r, r).bool()


def _block_counts(mask: torch.Tensor) -> torch.Tensor:
    r = mask.shape[0]
    W = words_a_row(r)
    per_word = torch.zeros((r * r, 32 * W), dtype=torch.int32,
                           device=mask.device)
    per_word[:, :r] = mask.reshape(r * r, r).to(torch.int32)
    per_word = per_word.reshape(-1, 32).sum(-1, dtype=torch.int32)
    nb = n_blocks(r)
    pad = per_word.new_zeros(nb * THREADS)
    pad[:per_word.shape[0]] = per_word
    return pad.reshape(nb, THREADS).sum(-1, dtype=torch.int32)


def upsample_marks_plain(occ_c: torch.Tensor, ev_c: torch.Tensor):
    """``level_upsample`` with marks: (occ_f, ev_f, the mixed bits' words
    [r * r, W] int32)."""
    return (upsample_plain(occ_c), fine_evaluated_plain(ev_c),
            pack_rows(mixed_plain(occ_c)))


def mark_plain(raw: torch.Tensor, ev_c: Optional[torch.Tensor], r: int,
               k: int):
    """``level_mark``: the words of the k^3 dilation of the mixed bits
    ``raw`` minus the coarse flags ``ev_c`` at even voxels, and the block
    counts."""
    mask = smooth_conv3d(unpack_rows(raw, r).to(torch.float32), k) > 0
    if ev_c is not None:
        mask = mask & ~fine_evaluated_plain(ev_c)
    return pack_rows(mask), _block_counts(mask)


def pack_plain(mask: torch.Tensor):
    """``level_mark`` in byte mode: (words, block counts) of ``mask``."""
    return pack_rows(mask), _block_counts(mask)


def compact_words_plain(words: torch.Tensor, r: int, budget: int):
    """``level_compact``: (idx, points, counts) of the set bits of
    ``words``."""
    return compact_points_plain(unpack_rows(words, r), budget)


# ----------------------------------------------------------------------
# the wrappers


def _check_grid(name: str, t: torch.Tensor, dtype) -> None:
    if t.ndim != 3 or len(set(t.shape)) != 1:
        raise ValueError(f"{name} must be a cubic [r, r, r] grid, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def upsample(occ: torch.Tensor) -> torch.Tensor:
    """The fine grid ``[2 rc - 1]^3`` of ``occ [rc, rc, rc]`` float32: on
    the card one launch of ``level_upsample`` into a new buffer, on the CPU
    :func:`upsample_plain`."""
    global launches_upsample
    _check_grid("occ", occ, torch.float32)
    if not _on_card(occ):
        return upsample_plain(occ)
    r = 2 * occ.shape[0] - 1
    out = _upsample(occ, torch.empty((r, r, r), dtype=torch.float32,
                                     device=occ.device))
    launches_upsample += 1
    return out


def _upsample(occ, out):
    """``level_upsample`` without marks into ``out``; counts nothing."""
    lib = _load()
    with torch.cuda.device(occ.device):
        _raise_on(lib, lib.icon_level_upsample(
            occ.data_ptr(), None, occ.shape[0], out.data_ptr(), None, None,
            _stream()), "icon_level_upsample launch")
    return out


def _upsample_marks(occ_c, ev_c, outs=None):
    """``level_upsample`` with marks into (occ_f, ev_f, raw) (new, or the
    caller's ``outs``); counts nothing."""
    rc = occ_c.shape[0]
    r = 2 * rc - 1
    dev = occ_c.device
    if outs is None:
        outs = (torch.empty((r, r, r), dtype=torch.float32, device=dev),
                torch.empty((r, r, r), dtype=torch.bool, device=dev),
                torch.empty((r * r, words_a_row(r)), dtype=torch.int32,
                            device=dev))
    occ_f, ev_f, raw = outs
    lib = _load()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.icon_level_upsample(
            occ_c.data_ptr(), ev_c.data_ptr(), rc, occ_f.data_ptr(),
            ev_f.data_ptr(), raw.data_ptr(), _stream()),
            "icon_level_upsample launch")
    return outs


def _mark(raw, ev_c, r: int, k: int, outs=None):
    """``level_mark`` (dilation) into (words, block counts); counts
    nothing."""
    return _mark_launch(raw, MARK_DILATE, ev_c, r, k // 2, outs)


def _pack(mask, outs=None):
    """``level_mark`` in byte mode; counts nothing."""
    return _mark_launch(mask, MARK_BYTES, None, mask.shape[0], 0, outs)


def _mark_launch(src, mode, ev_c, r, h, outs):
    dev = src.device
    if outs is None:
        outs = (torch.empty((r * r, words_a_row(r)), dtype=torch.int32,
                            device=dev),
                torch.empty((n_blocks(r),), dtype=torch.int32, device=dev))
    words, counts = outs
    lib = _load()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.icon_level_mark(
            src.data_ptr(), mode,
            None if ev_c is None else ev_c.data_ptr(),
            0 if ev_c is None else ev_c.shape[0], r, h, words.data_ptr(),
            counts.data_ptr(), _stream()), "icon_level_mark launch")
    return outs


def _compact_words(words, block_counts, r: int, budget: int, outs=None):
    """``level_compact`` into (idx, points, counts); counts nothing."""
    dev = words.device
    if outs is None:
        outs = (torch.empty((budget,), dtype=torch.int64, device=dev),
                torch.empty((budget, 3), dtype=torch.float32, device=dev),
                torch.empty((3,), dtype=torch.int64, device=dev))
    idx, pts, counts = outs
    lib = _load()
    with torch.cuda.device(dev):
        _raise_on(lib, lib.icon_level_compact(
            words.data_ptr(), block_counts.data_ptr(), r, budget, *B_MIN,
            *B_MAX, idx.data_ptr(), pts.data_ptr(), counts.data_ptr(),
            _stream()), "icon_level_compact launch")
    return outs


def _write(occ, ev, idx, counts, vals) -> None:
    """``level_write`` in place; counts nothing."""
    lib = _load()
    with torch.cuda.device(occ.device):
        _raise_on(lib, lib.icon_level_write(
            occ.data_ptr(), ev.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            vals.data_ptr(), idx.shape[0], _stream()),
            "icon_level_write launch")


def level_select(occ_c: torch.Tensor, ev_c: torch.Tensor, k: int,
                 budget: int) -> Tuple[torch.Tensor, ...]:
    """(occ_f [r]^3 f32, ev_f [r]^3 bool, idx [budget] int64, points
    [budget, 3] f32, counts [3] int64 = (n_sel, total, overflow)) of
    :func:`level_select_plain` for ``occ_c [rc]^3`` float32 and ``ev_c``
    bool, r = 2 rc - 1, an odd box size ``k`` below 64. On the card three
    launches on the current stream into new buffers; on the CPU the plain
    twin."""
    global launches_upsample, launches_mark, launches_compact
    _check_grid("occ_c", occ_c, torch.float32)
    _check_grid("ev_c", ev_c, torch.bool)
    if ev_c.shape != occ_c.shape or ev_c.device != occ_c.device:
        raise ValueError("occ_c and ev_c differ in shape or device")
    if k < 1 or k % 2 == 0 or k > 63:
        raise ValueError(f"the box size must be odd and below 64, got {k}")
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if not _on_card(occ_c):
        return level_select_plain(occ_c, ev_c, k, budget)
    r = 2 * occ_c.shape[0] - 1
    occ_f, ev_f, raw = _upsample_marks(occ_c, ev_c)
    launches_upsample += 1
    words, block_counts = _mark(raw, ev_c, r, k)
    launches_mark += 1
    idx, pts, counts = _compact_words(words, block_counts, r, budget)
    launches_compact += 1
    return occ_f, ev_f, idx, pts, counts


def compact(mask: torch.Tensor, budget: int) -> Tuple[torch.Tensor, ...]:
    """(idx, points, counts) of :func:`compact_points_plain` for a bool grid
    ``mask [r, r, r]``: on the card ``level_mark`` in byte mode and
    ``level_compact``, on the CPU the plain twin."""
    global launches_mark, launches_compact
    _check_grid("mask", mask, torch.bool)
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if not _on_card(mask):
        return compact_points_plain(mask, budget)
    words, block_counts = _pack(mask)
    launches_mark += 1
    out = _compact_words(words, block_counts, mask.shape[0], budget)
    launches_compact += 1
    return out


def level_write(occ: torch.Tensor, ev: torch.Tensor, idx: torch.Tensor,
                counts: torch.Tensor, vals: torch.Tensor):
    """(occ, ev) with ``vals [budget]`` float32 and True at the slots below
    ``counts[0]`` (``idx [budget]`` int64, distinct live indices). On the
    card one launch of ``level_write``, in place, returning ``occ`` and
    ``ev`` themselves; on the CPU :func:`write_plain` (new tensors)."""
    global launches_write
    _check_grid("occ", occ, torch.float32)
    _check_grid("ev", ev, torch.bool)
    if idx.ndim != 1 or vals.shape != idx.shape or counts.shape != (3,):
        raise ValueError(f"idx [B], vals [B] and counts [3] expected, got "
                         f"{tuple(idx.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(counts.shape)}")
    if idx.dtype != torch.int64 or counts.dtype != torch.int64 or \
            vals.dtype != torch.float32:
        raise TypeError("idx and counts must be int64, vals float32")
    if not _on_card(occ):
        return write_plain(occ, ev, idx, counts, vals)
    for name, t in (("idx", idx), ("counts", counts), ("vals", vals),
                    ("ev", ev)):
        if t.device != occ.device:
            raise ValueError(f"{name} on {t.device}, occ on {occ.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.shape[0]:
        _write(occ, ev, idx, counts, vals)
        launches_write += 1
    return occ, ev
