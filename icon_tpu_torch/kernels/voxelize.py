"""Semantic voxelization: the CUDA kernels and their plain twins.

:func:`voxelize_semantic` is the wrapper PaMIR's query calls. A CUDA
tensor launches ``csrc/voxelize.cu``, a CPU tensor takes the plain version
(``ops/voxelize.py``: :func:`voxel_splat_plain`,
:func:`box_smooth3d_plain`):

- ``voxel_splat``: a thread per (vertex, trilinear corner), a warp per 32
  vertices of one corner; lanes whose corners land in the same voxel
  (``__match_any_sync``) sum their ``(w * code, w)`` in the warp, and one
  lane per voxel adds the float4 with one 16-byte vector atomic into the
  zeroed ``[B, res^3, 4]`` accumulator. The order of the sums changes from
  run to run: every term is non-negative, so a voxel of m terms is within
  2 m 2^-24 of the plain version's sum.
- ``box_smooth3d``: two launches. The D pass streams each (y, x) column
  through z into a scratch ``t1`` of the accumulator's size; the H and W
  pass copies a plane's tile and its halo of ``t1`` into shared memory
  (``cp.async``, zero filled outside the volume), sums H, then W, and
  writes the codes over ``max(w, 1e-3)``. Each window is summed from 0.0
  in the order of its offsets and divided by k correctly rounded:
  bit-identical to the plain version. :func:`smooth_geometry` picks the D
  pass's outputs a thread and the tile per k, within 227 KB of shared
  memory: k up to :data:`MAX_K`. :func:`division_mismatches` holds the
  kernels' division by k to IEEE division.

The backward, JAX's autodiff of the same function with its rules at ties
(``ops/voxelize.py``: :func:`box_smooth3d_bwd_plain`,
:func:`voxel_splat_bwd_plain`), is one private entry,
:func:`_voxelize_bwd`, which ``_Voxelize.backward`` calls:

- ``box_smooth3d_bwd``: the accumulator's gradient only at the voxels the
  splat's backward reads, those of the vertices' trilinear corners inside
  the volume. A lane per (vertex, corner) marks and lists the bricks (2 x
  8 x 8 voxels, one plane past k = 74) that hold such a voxel; persistent
  blocks then walk the list, each brick's D, H and W sums of the mirrored
  window over its halo in shared memory, each voxel's gradient of the
  smoothed accumulator formed from the output's gradient, the output and
  the smoothed weight the forward kept (under a gradient its H and W pass
  also writes the weight) as it is read. Each written voxel is
  bit-identical to the plain version's
  (:func:`box_smooth3d_bwd_rows_plain` sums them in the kernel's order).
  The count and the marks (64 KB at 128^3) are zeroed by each call.
- ``voxel_splat_bwd``: a lane per (vertex, corner) gathers its voxel's
  gradient; the vertex's eight lanes add their terms by shuffles in the
  plain version's corner order: no atomics, its sums in its order.

:func:`voxelize_semantic` differentiates through an
``autograd.Function`` when an input needs a gradient (on the CPU the same
Function over the plain versions); otherwise it launches the two forward
kernels as before and keeps nothing. All the kernels need 16-byte aligned
float32 accumulators. ``launches_splat``, ``launches_smooth``,
``launches_splat_bwd`` and ``launches_smooth_bwd`` count the wrappers'
launches (a smooth call, or its backward's, is one count for its
launches).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from torch.autograd.function import once_differentiable

from icon_tpu_torch.ops import voxelize as pv

launches_splat = 0      # voxel_splat launches since the last reset
launches_smooth = 0     # box_smooth3d launches since the last reset
launches_splat_bwd = 0  # voxel_splat_bwd launches since the last reset
launches_smooth_bwd = 0  # box_smooth3d_bwd launches since the last reset

MAX_SMEM = 232448       # csrc/voxelize.cu's kMaxSmem: 227 KB a block
TILES = ((64, 16), (32, 16), (16, 16), (16, 8), (8, 8))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class SmoothGeometry(NamedTuple):
    """A ``box_smooth3d`` launch: ``rz`` outputs a thread in the D pass;
    the H and W passes on ``(tx, ty)`` tiles of a plane."""
    rz: int
    tx: int
    ty: int


def smooth_smem(k: int, tx: int, ty: int) -> int:
    """Shared bytes of an H and W block: the ``(tx + k - 1) x (ty + k -
    1)`` halo tile and the H pass's ``ty`` lines of ``tx + k - 1``. Must
    match ``icon_box_smooth3d``'s check in ``csrc/voxelize.cu``, which
    refuses a tile past ``MAX_SMEM``."""
    return 16 * (tx + k - 1) * (2 * ty + k - 1)


MAX_K = max(k for k in range(1, 256) if smooth_smem(k, *TILES[-1]) <= MAX_SMEM)


def smooth_geometry(k: int) -> SmoothGeometry:
    """The ``box_smooth3d`` launch for box ``k``: the D pass's outputs a
    thread, the most (up to 16) its ``slide`` takes (``k >= rz - 1``); the
    first of :data:`TILES` whose shared memory fits :data:`MAX_SMEM`.
    Raises ``ValueError`` past :data:`MAX_K`."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"box_smooth3d's kernel takes 1 <= k <= {MAX_K} "
                         f"(the halo of an 8 x 8 tile in {MAX_SMEM} bytes "
                         f"of shared memory), got k={k}")
    rz = next(rz for rz in (16, 8, 4, 2) if k >= rz - 1)
    tx, ty = next(t for t in TILES if smooth_smem(k, *t) <= MAX_SMEM)
    return SmoothGeometry(rz, tx, ty)


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            lib = ctypes.CDLL(build()["voxelize.cu"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.icon_voxel_splat.argtypes = [vp, vp] + [ci] * 4 + [vp, vp]
            lib.icon_voxel_splat.restype = ci
            lib.icon_box_smooth3d.argtypes = [vp] * 3 + [ci] * 8 + [vp]
            lib.icon_box_smooth3d.restype = ci
            lib.icon_box_smooth3d_keep.argtypes = [vp] * 4 + [ci] * 8 + [vp]
            lib.icon_box_smooth3d_keep.restype = ci
            lib.icon_box_smooth3d_bwd.argtypes = [vp] * 4 + [ci] * 4 + \
                [vp] * 3
            lib.icon_box_smooth3d_bwd.restype = ci
            lib.icon_box_smooth3d_bwd_scratch.argtypes = [ci] * 3
            lib.icon_box_smooth3d_bwd_scratch.restype = ctypes.c_longlong
            lib.icon_voxel_splat_bwd.argtypes = [vp] * 3 + [ci] * 4 + \
                [vp] * 3
            lib.icon_voxel_splat_bwd.restype = ci
            lib.icon_voxel_div_check.argtypes = [ci, vp, vp]
            lib.icon_voxel_div_check.restype = ci
            lib.icon_voxel_error_string.argtypes = [ci]
            lib.icon_voxel_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def division_mismatches(kmax: int = MAX_K) -> int:
    """On the card: how many (k, x), k in [1, ``kmax``] and x any float32
    in [1, 2), the smooth's division by k (a correction of ``x * RN(1/k)``,
    exact for every exponent from -64 to 63 if it is for one) rounds
    differently from ``__fdiv_rn``: 0 for a correct kernel."""
    lib = _load()
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = lib.icon_voxel_div_check(kmax, bad.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "icon_voxel_div_check")
    return int(bad.item())


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.icon_voxel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _check_card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, expected a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def voxel_splat(verts: torch.Tensor, codes: torch.Tensor,
                res: int) -> torch.Tensor:
    """The splat's accumulators ``[B, res^3, 4]`` (``w * code`` in 0..2,
    ``w`` in 3) of ``verts [B, V, 3]`` and ``codes [V, 3]`` or ``[B, V,
    3]``. CPU tensors take :func:`voxel_splat_plain`; CUDA tensors launch
    the kernel on the current stream or raise."""
    global launches_splat
    if verts.ndim != 3 or verts.shape[-1] != 3 or codes.ndim not in (2, 3) \
            or codes.shape[-2] != verts.shape[1]:
        raise ValueError(f"verts [B, V, 3] and codes [V, C] or [B, V, C] "
                         f"expected, got {tuple(verts.shape)} and "
                         f"{tuple(codes.shape)}")
    if verts.device.type == "cpu":
        return pv.voxel_splat_plain(verts, codes, res)
    _check_card("verts", verts)
    _check_card("codes", codes)
    if codes.shape[-1] != 3 or (codes.ndim == 3 and
                                codes.shape[0] != verts.shape[0]):
        raise ValueError(f"the kernel takes 3 code channels per vertex, got "
                         f"codes {tuple(codes.shape)}")
    if codes.device != verts.device:
        raise ValueError(f"verts on {verts.device}, codes on {codes.device}")
    if res < 1:
        raise ValueError(f"res must be at least 1, got {res}")
    B, V = verts.shape[:2]
    acc = torch.empty((B, res ** 3, 4), dtype=torch.float32,
                      device=verts.device)
    _splat(verts, codes, res, acc)
    launches_splat += 1
    return acc


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels move "
                         f"float4), its base is at {t.data_ptr():#x}")


def _splat(verts, codes, res: int, acc) -> None:
    """One ``voxel_splat`` (zeroing ``acc [B, res^3, 4]`` first) on
    caller-checked tensors, on the current stream; counts nothing. Raises
    ``ValueError`` if ``acc`` is not 16-byte aligned."""
    _check_aligned("acc", acc)
    lib = _load()
    B, V = verts.shape[:2]
    with torch.cuda.device(verts.device):
        err = lib.icon_voxel_splat(
            verts.data_ptr(), codes.data_ptr(), B, V, int(codes.ndim == 3),
            res, acc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "voxel_splat")


def box_smooth3d(acc: torch.Tensor, k: int, keep_weight: bool = False):
    """``acc [B, D, H, W, C + 1]`` box-smoothed (size ``k``, zero padded)
    over D, H and W, the first C channels over ``max(channel C, 1e-3)``:
    ``[B, D, H, W, C]``; with ``keep_weight``, (that, the smoothed channel
    C ``[B, D, H, W]``). CPU tensors take :func:`box_smooth3d_plain`;
    CUDA tensors (C = 3) launch the kernel on the current stream or
    raise. ``acc`` is left as it is."""
    global launches_smooth
    if acc.ndim != 5:
        raise ValueError(f"acc [B, D, H, W, C + 1] expected, got "
                         f"{tuple(acc.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if acc.device.type == "cpu":
        return pv.box_smooth3d_plain(acc, k, keep_weight)
    _check_card("acc", acc)
    if acc.shape[-1] != 4:
        raise ValueError(f"the kernel takes 4 channels, got "
                         f"{tuple(acc.shape)}")
    out = torch.empty(acc.shape[:4] + (3,), dtype=torch.float32,
                      device=acc.device)
    weight = torch.empty(acc.shape[:4], dtype=torch.float32,
                         device=acc.device) if keep_weight else None
    _smooth(acc, k, torch.empty_like(acc), out, weight)
    launches_smooth += 1
    return (out, weight) if keep_weight else out


def _smooth(acc, k: int, t1, out, weight=None) -> None:
    """One ``box_smooth3d`` (the D pass into the scratch ``t1`` of
    ``acc``'s size, then the H and W passes into ``out``, and the smoothed
    weight into ``weight`` unless None) on caller-checked tensors, on the
    current stream, launched as :func:`smooth_geometry` says; counts
    nothing. Raises ``ValueError`` past :data:`MAX_K` or if ``acc`` or
    ``t1`` is not 16-byte aligned."""
    g = smooth_geometry(k)
    _check_aligned("acc", acc)
    _check_aligned("t1", t1)
    B, D, H, W = acc.shape[:4]
    lib = _load()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        if weight is None:
            err = lib.icon_box_smooth3d(
                acc.data_ptr(), t1.data_ptr(), out.data_ptr(), B, D, H, W,
                k, g.rz, g.tx, g.ty, stream)
        else:
            err = lib.icon_box_smooth3d_keep(
                acc.data_ptr(), t1.data_ptr(), out.data_ptr(),
                weight.data_ptr(), B, D, H, W, k, g.rz, g.tx, g.ty, stream)
    _raise_on(lib, err, "box_smooth3d")


def _voxelize_bwd(verts, codes, g_out, out, weight, res: int, k: int,
                  codes_grad: bool = True):
    """The gradients (``verts``', and ``codes``' or None without
    ``codes_grad``) of :func:`voxelize_semantic` from its output's gradient
    ``g_out``, given what the forward kept: its output ``out`` and smoothed
    weight ``weight``. CPU tensors take :func:`box_smooth3d_bwd_plain` and
    :func:`voxel_splat_bwd_plain`; CUDA tensors launch ``box_smooth3d_bwd``
    and ``voxel_splat_bwd`` on the current stream or raise."""
    global launches_smooth_bwd, launches_splat_bwd
    B = verts.shape[0]
    shape = (B, res, res, res)
    if out.shape != shape + (codes.shape[-1],) or g_out.shape != out.shape \
            or weight.shape != shape:
        raise ValueError(f"g_out and out [B, res, res, res, C] and weight "
                         f"[B, res, res, res] of verts' batch expected, got "
                         f"{tuple(g_out.shape)}, {tuple(out.shape)} and "
                         f"{tuple(weight.shape)} for verts "
                         f"{tuple(verts.shape)}")
    if verts.device.type == "cpu":
        g_acc = pv.box_smooth3d_bwd_plain(g_out, out, weight, k)
        return pv.voxel_splat_bwd_plain(verts, codes, g_acc.view(B, -1, 4),
                                        res, codes_grad)
    for name, t in (("g_out", g_out), ("out", out), ("weight", weight),
                    ("verts", verts), ("codes", codes)):
        _check_card(name, t)
    if codes.shape[-1] != 3:
        raise ValueError(f"the kernels take 3 code channels per vertex, got "
                         f"codes {tuple(codes.shape)}")
    dev = out.device
    g_acc = torch.empty(shape + (4,), dtype=torch.float32, device=dev)
    _smooth_bwd(g_out, out, weight, k, verts, _bwd_scratch(B, res, k, dev),
                g_acc)
    launches_smooth_bwd += 1
    g_verts = torch.empty_like(verts)
    g_codes = torch.empty_like(codes) if codes_grad else None
    _splat_bwd(verts, codes, g_acc.view(B, -1, 4), res, g_verts, g_codes)
    launches_splat_bwd += 1
    return g_verts, g_codes


def _bwd_scratch(B: int, res: int, k: int, device) -> torch.Tensor:
    """:func:`_smooth_bwd`'s int32 scratch for ``B`` volumes of ``res^3``
    and box ``k`` on ``device`` (a count, a mark a brick and the list of
    bricks; ``icon_box_smooth3d_bwd`` zeroes what must be zero). Raises
    ``ValueError`` past :data:`MAX_K` (the one-plane brick's halo then
    outgrows shared memory, as the forward's 8 x 8 tile does)."""
    words = _load().icon_box_smooth3d_bwd_scratch(B, res, k)
    if words < 0:
        raise ValueError(f"box_smooth3d_bwd's kernel takes 1 <= k <= "
                         f"{MAX_K}, got k={k} (B={B}, res={res})")
    return torch.empty((words,), dtype=torch.int32, device=device)


def _smooth_bwd(g_out, out, weight, k: int, verts, scratch, g_acc) -> None:
    """One ``box_smooth3d_bwd`` (the count and marks zeroed, the mark
    launch, then the bricks) into ``g_acc`` at the voxels of ``verts``'
    trilinear corners (``ops/voxelize.py:touched_rows``; the other voxels
    are left as they were) on caller-checked tensors of a cube, on the
    current stream, with ``scratch`` from :func:`_bwd_scratch`; counts
    nothing. Raises ``ValueError`` if ``g_acc`` is not 16-byte aligned."""
    _check_aligned("g_acc", g_acc)
    B, V = verts.shape[:2]
    lib = _load()
    with torch.cuda.device(out.device):
        err = lib.icon_box_smooth3d_bwd(
            g_out.data_ptr(), out.data_ptr(), weight.data_ptr(),
            verts.data_ptr(), B, V, out.shape[1], k, scratch.data_ptr(),
            g_acc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "box_smooth3d_bwd")


def _splat_bwd(verts, codes, g_acc, res: int, g_verts, g_codes) -> None:
    """One ``voxel_splat_bwd`` from ``g_acc [B, res^3, 4]`` (read at the
    voxels of the vertices' corners inside the volume) into ``g_verts``
    and ``g_codes`` (None: not computed) on caller-checked tensors, on the
    current stream; counts nothing. Raises ``ValueError`` if ``g_acc`` is
    not 16-byte aligned."""
    _check_aligned("g_acc", g_acc)
    lib = _load()
    B, V = verts.shape[:2]
    with torch.cuda.device(verts.device):
        err = lib.icon_voxel_splat_bwd(
            verts.data_ptr(), codes.data_ptr(), g_acc.data_ptr(), B, V,
            int(codes.ndim == 3), res, g_verts.data_ptr(),
            None if g_codes is None else g_codes.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "voxel_splat_bwd")


class _Voxelize(torch.autograd.Function):
    """:func:`voxelize_semantic` under a gradient: the forward's two
    launches (the smooth keeping its weight) and the backward's two, or
    their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, verts, codes, res: int, k: int):
        acc = voxel_splat(verts, codes, res)
        out, weight = box_smooth3d(acc.view(verts.shape[0], res, res, res,
                                            acc.shape[-1]), k,
                                   keep_weight=True)
        ctx.save_for_backward(verts, codes, out, weight)
        ctx.res, ctx.k = res, k
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        verts, codes, out, weight = ctx.saved_tensors
        g_verts, g_codes = _voxelize_bwd(
            verts, codes, g_out.contiguous(), out, weight, ctx.res, ctx.k,
            codes_grad=ctx.needs_input_grad[1])
        return (g_verts if ctx.needs_input_grad[0] else None), g_codes, \
            None, None


def voxelize_semantic(verts: torch.Tensor, codes: torch.Tensor,
                      res: int = 128, sigma: float = 0.05,
                      smooth_kernel: Optional[int] = None) -> torch.Tensor:
    """``ops.voxelize.voxelize_semantic`` through the kernels:
    ``[B, res, res, res, 3]`` indexed [z, y, x]. CPU tensors take the plain
    versions; CUDA tensors launch ``voxel_splat`` and ``box_smooth3d`` or
    raise. Where an input needs a gradient (and grad mode is on), through
    :class:`_Voxelize`: the backward launches ``box_smooth3d_bwd`` and
    ``voxel_splat_bwd`` (the plain twins on the CPU), JAX's gradient."""
    k = pv.smooth_kernel_size(res, sigma) if smooth_kernel is None \
        else smooth_kernel
    if torch.is_grad_enabled() and (verts.requires_grad or
                                    codes.requires_grad):
        return _Voxelize.apply(verts, codes, res, k)
    acc = voxel_splat(verts, codes, res)
    return box_smooth3d(acc.view(verts.shape[0], res, res, res,
                                 acc.shape[-1]), k)
