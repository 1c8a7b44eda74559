"""On-device iso-surface extraction (``icon_tpu.recon.marching``).

Marching tetrahedra (Kuhn 6-tet subdivision) over an occupancy grid, in two
codecs:

- **indexed** (:func:`marching_tetrahedra_indexed`, the one-shot export's):
  an explicit mesh, triangles in (cell, slot) order and vertices deduped
  by their lattice edge ids, in ascending id order, by the hand-written
  ``mt_emit`` and ``mt_index`` kernels (``kernels/marching.py``); packed
  into one buffer (:func:`pack_mesh`, exact float32 or 10.6 fixed point)
  and decoded on the host (:func:`unpack_mesh`).
- **lattice** (:func:`marching_lattice`, the serving wire): unique vertices
  as (lattice edge id, fraction along the edge) and active cells as (cell
  id, 8 corner-inside bits), from the hand-written ``lattice_cells`` and
  ``lattice_emit`` kernels (``kernels/lattice.py``). Every lattice edge has
  exactly one owner cell, so vertices are unique by construction. The
  faces follow from the corner bits through the (tet, case) tables: on the
  card ``lattice_decode`` builds the host decoder's mesh there and
  :class:`AutoMarcher` copies it whole; on the CPU the wire
  (:func:`pack_lattice`) goes to the host decoder
  (:mod:`icon_tpu_torch.recon.lattice_host`).
  :func:`marching_lattice_virtual` marches the engine's final level as the
  virtual 2x upsample of its coarse grid, which never materializes.

Edge ids ``plin * 8 + dir`` are int64 on the device (the JAX package's int32
ids wrap past ~645^3). The lattice wire is word-for-word the JAX package's:
wire v2 (implicit edge ids, the serving default) carries no edge ids at
all; wire v1 carries them as int32 and raises for a grid whose ids do not
fit.

The serving marcher (:class:`AutoMarcher`) never waits for the card in
``__call__`` or :meth:`AutoMarcher.pack`: its counts and its packed
buffer (on the card, its decoded mesh) start their copies to pinned host
memory at once
(``engine.HostCopy``), the counts are taken once landed, and only
:meth:`AutoMarcher.unpack` (or :meth:`AutoMarcher.decode`, which a worker
thread may run) waits, for its own frame's buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from icon_tpu_torch.kernels.lattice import (LatticeOut, _coarse_candidates,
                                            decode_sizes, lattice_cells,
                                            lattice_decode, lattice_emit,
                                            unpack_decoded)
from icon_tpu_torch.kernels.marching import mt_emit, mt_index
from icon_tpu_torch.ops.constants import device_constant
from icon_tpu_torch.recon.engine import HostCopy, _compact
from icon_tpu_torch.recon.lattice_host import decode_lattice

_INT32_MAX = 2 ** 31 - 1
_INT64_MAX = 2 ** 63 - 1
_HEADROOM = 1.3         # buffer and pack sizes over the measured counts
_DECODED = "decoded"    # a pack token's meta: the mesh decoded on the card


def _active_cells(occ: torch.Tensor, iso: float, max_cells: int,
                  coarse_occ: Optional[torch.Tensor],
                  max_candidates: Optional[int] = None):
    """Candidate cells (``kernels/lattice.py:lattice_cells``). Returns
    (cx, cy, cz, cell_idx, alive_cells, n_cells, n_cells_total), each
    [max_cells] except the 0-d counts.

    With ``coarse_occ`` (``occ`` is its 2x align_corners upsample sliced by
    one), every mixed coarse cell expands into its 8 fine cells (buffer
    ``max_candidates``); those that are exactly mixed at fine resolution
    are compacted into the [max_cells] output."""
    c = lattice_cells(occ, iso, max_cells, coarse_occ, max_candidates)
    alive = torch.arange(max_cells, device=occ.device) < c.n_cells
    return c.cx, c.cy, c.cz, c.cell_idx, alive, c.n_cells, c.n_cells_total


class MarchOut(NamedTuple):
    verts_x: torch.Tensor      # [max_verts] f32, ascending edge-id order
    verts_y: torch.Tensor
    verts_z: torch.Tensor
    faces: torch.Tensor        # [max_tris, 3] int32 into the vertex rows
    n_verts: torch.Tensor      # 0-d, clamped to max_verts
    n_tris: torch.Tensor       # 0-d, clamped to max_tris
    n_cells: torch.Tensor      # 0-d, cells in the buffer (<= max_cells)
    n_tris_total: torch.Tensor  # true count; > n_tris = overflow
    n_cells_total: torch.Tensor  # candidate cells; > n_cells = overflow


def marching_tetrahedra_indexed(occ: torch.Tensor, iso: float = 0.5,
                                max_cells: int = 1 << 18,
                                max_tris: int = 1 << 20,
                                max_verts: int = 1 << 19,
                                coarse_occ: Optional[torch.Tensor] = None,
                                max_candidates: Optional[int] = None
                                ) -> MarchOut:
    """An indexed mesh of ``occ [D, H, W]`` ([z, y, x]) in grid
    coordinates (x, y, z), faces wound counter-clockwise seen from the
    outside (occ < iso). The active cells (with ``coarse_occ``, ``occ``'s
    2x align_corners source before the slice by one, only those of its
    mixed cells) go through ``mt_emit`` (triangles in linear (cell, slot)
    order, the first ``max_tris``) and ``mt_index`` (vertices deduped by
    edge id, ascending; the first ``max_verts``)."""
    occ = occ.contiguous()
    cx, cy, cz, _, _, n_cells, n_cells_total = \
        _active_cells(occ, iso, max_cells, coarse_occ, max_candidates)
    tvx, tvy, tvz, teid, n_tris, n_tris_total = mt_emit(
        occ, cx, cy, cz, n_cells, iso, max_tris)
    vx, vy, vz, faces, n_unique = mt_index(tvx, tvy, tvz, teid, n_tris,
                                           max_verts, tuple(occ.shape))
    return MarchOut(vx, vy, vz, faces, torch.clamp(n_unique, max=max_verts),
                    n_tris, n_cells, n_tris_total, n_cells_total)


def marching_tetrahedra(occ: torch.Tensor, iso: float = 0.5,
                        max_cells: int = 1 << 18, max_tris: int = 1 << 20):
    """Triangle soup of :func:`marching_tetrahedra_indexed`: (tri_verts
    [max_tris, 3, 3], tri_mask [max_tris], n_cells, n_tris); dead rows
    are zero."""
    out = marching_tetrahedra_indexed(occ, iso, max_cells=max_cells,
                                      max_tris=max_tris,
                                      max_verts=min(2 * max_tris, 1 << 21))
    f = out.faces.long()
    n = out.verts_x.shape[0]
    f = torch.clamp(f, max=n - 1)      # ranks past max_verts: dead rows
    tri = torch.stack([out.verts_x[f], out.verts_y[f], out.verts_z[f]], -1)
    mask = torch.arange(f.shape[0], device=f.device) < out.n_tris
    tri = torch.where(mask[:, None, None], tri, torch.zeros_like(tri))
    return tri, mask, out.n_cells, out.n_tris


def marching_lattice(occ: torch.Tensor, iso: float = 0.5,
                     max_cells: int = 1 << 18, max_verts: int = 1 << 19,
                     coarse_occ: Optional[torch.Tensor] = None,
                     max_candidates: Optional[int] = None) -> LatticeOut:
    """Marching tetrahedra over ``occ [D, H, W]`` ([z, y, x]) emitting the
    lattice codec; see the module docstring. The active cells come from
    ``lattice_cells`` and the vertices from ``lattice_emit``
    (``kernels/lattice.py``)."""
    c = lattice_cells(occ, iso, max_cells, coarse_occ, max_candidates)
    return lattice_emit(c.cvals, c.cx, c.cy, c.cz, c.cell_idx, c.n_cells,
                        c.n_cells_total, tuple(occ.shape), iso, max_verts)


def marching_lattice_virtual(coarse_occ: torch.Tensor, iso: float = 0.5,
                             max_cells: int = 1 << 18,
                             max_verts: int = 1 << 19,
                             max_candidates: Optional[int] = None
                             ) -> LatticeOut:
    """:func:`marching_lattice` over the VIRTUAL 2x align_corners upsample
    of ``coarse_occ``, sliced by one (the engine's faster-mode final level
    and the export convention): the fine corner values are interpolated
    at the candidate cells only, so the dense fine grid never exists (at
    1025^3 it alone is 4.3 GB; this path marches it from the 0.5 GB coarse
    grid). Equal to ``marching_lattice(upsample2x(coarse)[1:, 1:, 1:],
    coarse_occ=coarse)`` up to the interpolation's rounding.

    With align_corners 2x upsampling the unsliced fine value at index v is
    ``coarse[v / 2]`` for even v and the midpoint of its two neighbours for
    odd v, so a fine cell's 8 corners are separable 2-tap combinations of
    one coarse 2^3 block at ``floor((fine_sliced + 1) / 2)``."""
    Dc, Hc, Wc = coarse_occ.shape
    D, H, W = 2 * Dc - 2, 2 * Hc - 2, 2 * Wc - 2       # sliced fine dims
    dev = coarse_occ.device
    dt = coarse_occ.dtype
    nc_budget = (max_candidates or max_cells) // 8
    kx, ky, kz, cand_idx, valid, n_mixed_total = _coarse_candidates(
        coarse_occ, iso, (D, H, W), nc_budget)

    # one coarse 2^3 block a candidate cell, at the unsliced base // 2
    ux, uy, uz = kx + 1, ky + 1, kz + 1
    bx, by, bz = ux // 2, uy // 2, uz // 2
    o2 = torch.arange(2, device=dev)
    blin = (((bz[:, None, None, None] + o2[None, :, None, None]) * Hc +
             (by[:, None, None, None] + o2[None, None, :, None])) * Wc +
            (bx[:, None, None, None] + o2[None, None, None, :]))
    blk = coarse_occ.reshape(-1)[blin]                    # [mcand, z, y, x]

    # per-axis corner -> tap weights: an even base takes corner 0 exact
    # and corner 1 at the midpoint; an odd base the reverse
    w_even = device_constant([[1.0, 0.0], [0.5, 0.5]], dt, dev)
    w_odd = device_constant([[0.5, 0.5], [0.0, 1.0]], dt, dev)

    def wsel(u):                                          # [mcand, 2, 2]
        return torch.where(((u & 1) == 0)[:, None, None], w_even[None],
                           w_odd[None])

    def taps(w, a0, a1):              # w [n, c, 2] over the tap axis
        return w[..., 0] * a0 + w[..., 1] * a1

    wz, wy, wx = wsel(uz), wsel(uy), wsel(ux)
    t = taps(wz[:, :, None, None, :], blk[:, None, 0], blk[:, None, 1])
    t = taps(wy[:, None, :, None, :], t[:, :, None, 0], t[:, :, None, 1])
    t = taps(wx[:, None, None, :, :], t[..., None, 0], t[..., None, 1])
    cvals8 = t.reshape(-1, 8)                 # corner order c = x + 2y + 4z

    ins = cvals8 > iso
    mixed_f = valid & ins.any(-1) & (~ins).any(-1)
    cpos, n_cells, n_alive_total = _compact(mixed_f, max_cells)
    n_cells_total = n_alive_total + 8 * torch.clamp(
        n_mixed_total - nc_budget, min=0)
    return lattice_emit(cvals8[cpos], kx[cpos], ky[cpos], kz[cpos],
                        cand_idx[cpos], n_cells, n_cells_total, (D, H, W),
                        iso, max_verts)


def _pack4(b: torch.Tensor) -> torch.Tensor:
    """Little-endian u8 x4 per int32 word (zero padded)."""
    pad = (-b.shape[0]) % 4
    b8 = torch.cat([b.to(torch.uint8), b.new_zeros(pad, dtype=torch.uint8)])
    return b8.view(torch.int32)


def _pack_rows(sizes: Optional[Tuple[int, ...]], caps: Tuple[int, ...],
               bucket: int = 16384) -> Tuple[int, ...]:
    """The rows a pack holds: each of ``sizes`` (upper bounds; None, or
    any <= 0, means unknown: the caps) rounded up to ``bucket``, at most
    its cap."""
    if sizes is None or min(sizes) <= 0:
        sizes = caps
    return tuple(min(-(-w // bucket) * bucket, c)
                 for w, c in zip(sizes, caps))


def pack_lattice(out: LatticeOut, bucket: int = 16384,
                 sizes: Optional[Tuple[int, int]] = None,
                 implicit_eid: bool = False):
    """One int32 device buffer: [header 4 | vert_eid nvb (v1 only) |
    vert_s u8 x4/word | cell_id ncb | cell_bits u8 x4/word]. The header
    holds (n_verts, n_cells, implicit flag, 0), written on the device
    without a copy from the host, so packing never waits for it. ``sizes``
    = (n_verts, n_cells) upper bounds, rounded up to ``bucket``; the
    decoder reports an overflow when the true counts exceed them. Returns
    (buf, nvb, ncb)."""
    nvb, ncb = _pack_rows(sizes, (out.vert_eid.shape[0],
                                  out.cell_id.shape[0]), bucket)
    counts = torch.stack([out.n_verts, out.n_cells,
                          out.n_verts.new_full((), int(implicit_eid)),
                          out.n_verts.new_zeros(())]).to(torch.int32)
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


def pack_mesh(out: MarchOut, quantize: bool = True, bucket: int = 16384,
              sizes: Optional[Tuple[int, int]] = None):
    """One device buffer of the indexed mesh for a single host copy:
    ``(buf, nvb, ntb)``. Its first two words are the true (n_verts,
    n_tris), written on the device, so packing never waits for them.
    ``sizes`` = (n_verts, n_tris) upper bounds (default: the full buffers),
    rounded up to ``bucket``; :func:`unpack_mesh` reports an overflow when
    the true counts exceed them.

    ``quantize``: int32 words [header 2 | x | y << 16 a vertex | z pairs |
    f0 | f1 << 21 | f1 >> 11 | f2 << 10 a face]: vertices as 10.6 fixed
    point (error <= 1/128 of a cell, grids up to 1023), faces as two
    21-bit-index words (the JAX package's ``_pack_fn``, word for word).
    Otherwise float32 words [header (bits) | x | y | z | faces (bits)]."""
    cap_v = out.verts_x.shape[0]
    cap_t = out.faces.shape[0]
    if quantize and cap_v > (1 << 21):
        raise ValueError(f"{cap_v} vertex rows exceed the 21-bit face "
                         f"indices of the quantized wire")
    nvb, ntb = _pack_rows(sizes, (cap_v, cap_t), bucket)
    counts = torch.stack([out.n_verts, out.n_tris]).to(torch.int32)
    vx, vy, vz = out.verts_x[:nvb], out.verts_y[:nvb], out.verts_z[:nvb]
    f = out.faces[:ntb].to(torch.int32)
    if not quantize:
        buf = torch.cat([counts.view(torch.float32), vx, vy, vz,
                         f.reshape(-1).view(torch.float32)])
        return buf, nvb, ntb

    def q(v):
        return torch.clamp(torch.round(v * 64.0), 0, 65535).to(torch.int32)

    xq, yq, zq = q(vx), q(vy), q(vz)
    w_xy = xq | (yq << 16)
    zpad = torch.cat([zq, zq.new_zeros(nvb % 2)])
    w_zz = zpad[0::2] | (zpad[1::2] << 16)
    f0, f1, f2 = f[:, 0], f[:, 1], f[:, 2]
    w0 = f0 | ((f1 & 0x7FF) << 21)
    w1 = (f1 >> 11) | (f2 << 10)
    return torch.cat([counts, w_xy, w_zz, w0, w1]), nvb, ntb


def unpack_mesh(packed, quantize: bool = True,
                return_overflow: bool = False):
    """Host decode of a :func:`pack_mesh` buffer ``(buf, nvb, ntb)``,
    ``buf`` a device tensor (copied to the host, blocking) or a host array
    (such as a pinned tensor's numpy view): (verts [V, 3] f32, faces
    [F, 3] int64) (+ the overflow flag: the true counts exceeded the packed
    sizes, the mesh is truncated; faces past the copied vertices are
    dropped). Degenerate faces (dedup merges a
    triangle's vertices when the iso value sits on a lattice vertex) are
    dropped."""
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    if packed is None:
        return empty + (False,) if return_overflow else empty
    buf, nvb, ntb = packed
    host = buf.cpu().numpy() if torch.is_tensor(buf) else np.asarray(buf)
    hdr = host[:2].view(np.int32)
    nv_true, nt_true = int(hdr[0]), int(hdr[1])
    overflow = nv_true > nvb or nt_true > ntb
    nv = min(nv_true, nvb)
    nt = min(nt_true, ntb)
    host = host[2:]
    if nv == 0 or nt == 0:
        return empty + (overflow,) if return_overflow else empty
    if not quantize:
        vx = host[:nvb][:nv]
        vy = host[nvb:2 * nvb][:nv]
        vz = host[2 * nvb:3 * nvb][:nv]
        faces = host[3 * nvb:].view(np.int32).reshape(-1, 3)[:nt]
        verts = np.stack([vx, vy, vz], axis=-1).astype(np.float32)
    else:
        u = host.view(np.uint32)
        w_xy = u[:nvb][:nv]
        nz = (nvb + 1) // 2
        w_zz = u[nvb:nvb + nz]
        x = (w_xy & 0xFFFF).astype(np.float32) / 64.0
        y = (w_xy >> 16).astype(np.float32) / 64.0
        zfull = np.empty(nz * 2, np.float32)
        zfull[0::2] = (w_zz & 0xFFFF).astype(np.float32) / 64.0
        zfull[1::2] = (w_zz >> 16).astype(np.float32) / 64.0
        verts = np.stack([x, y, zfull[:nv]], axis=-1)
        w0 = u[nvb + nz:nvb + nz + ntb][:nt]
        w1 = u[nvb + nz + ntb:][:nt]
        f0 = w0 & 0x1FFFFF
        f1 = (w0 >> 21) | ((w1 & 0x3FF) << 11)
        f2 = w1 >> 10
        faces = np.stack([f0, f1, f2], axis=-1).astype(np.int64)
    if overflow:
        faces = faces[(faces < nv).all(axis=1)]
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) &
            (faces[:, 0] != faces[:, 2]))
    out = (verts, faces[good].astype(np.int64))
    return out + (overflow,) if return_overflow else out


def fetch_mesh(out: MarchOut, quantize: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`pack_mesh`, the host copy and :func:`unpack_mesh` in one
    call."""
    return unpack_mesh(pack_mesh(out, quantize=quantize), quantize=quantize)


def dedup_triangle_soup(tri_verts: np.ndarray, tri_mask: np.ndarray):
    """Host exact dedup of a triangle soup into (verts [V, 3], faces
    [F, 3] int64), degenerate faces dropped."""
    tris = np.asarray(tri_verts)[np.asarray(tri_mask)]
    flat = np.ascontiguousarray(tris.reshape(-1, 3), dtype=np.float32)
    uniq, inv = np.unique(flat.view([("x", np.float32), ("y", np.float32),
                                     ("z", np.float32)]),
                          return_inverse=True)
    verts = np.stack([uniq["x"], uniq["y"], uniq["z"]], axis=-1)
    faces = inv.reshape(-1, 3).astype(np.int64)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) &
            (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


class AutoMarcher:
    """A marcher with buffer autotuning across frames: each frame sizes its
    buffers from the previous frame's measured totals x ``headroom``,
    snapped to a geometric bucket ladder; the first frame and any frame
    after an overflow use the caps. The pack sizes come from the latest
    measured counts the same way. The counts are those of the latest march
    whose copy to the host has landed (``icon_tpu/recon/marching.py:
    918-938``): only the first is waited for."""

    def __init__(self, max_cells: int = 1 << 18, max_tris: int = 1 << 20,
                 max_verts: Optional[int] = None, iso: float = 0.5,
                 headroom: float = _HEADROOM, use_coarse: bool = True,
                 slice_one: bool = False, codec: str = "indexed",
                 virtual: bool = False, implicit_eid: bool = True):
        """``slice_one``: drop the first slice of each axis (the engine and
        export grid convention, seg3d_lossless.py:585). ``codec``: the
        wire :meth:`pack` and :meth:`unpack` use, ``"indexed"`` (explicit
        vertices and faces, :func:`pack_mesh`) or ``"lattice"`` (edge ids,
        fractions and cells, :func:`pack_lattice`, faces rebuilt on the
        host; a march on the card is decoded there, ``lattice_decode``);
        ``implicit_eid`` drops the lattice wire's edge-id block (wire
        v2): it shapes only the wire of a march on the CPU, as one on the
        card sends its decoded mesh. ``use_coarse``: take the candidate
        cells from the coarse grid when one is given. ``virtual``:
        ``__call__`` receives the engine's coarse final grid
        (``ReconEngine(virtual_final=True)``) and marches its virtual 2x
        upsample (:func:`marching_lattice_virtual`); it implies the lattice
        codec, and the slice by one is built into its mapping."""
        if codec not in ("indexed", "lattice"):
            raise ValueError(f"codec must be 'indexed' or 'lattice', got "
                             f"{codec!r}")
        if virtual and codec != "lattice":
            raise ValueError("virtual upsample marching emits the lattice "
                             "codec")
        self.virtual = virtual
        self.caps = (max_cells, max_tris,
                     max_verts or min(2 * max_tris, 1 << 21))
        self.iso = iso
        self.headroom = headroom
        self.use_coarse = use_coarse
        self.slice_one = slice_one
        self.codec = codec
        self.implicit_eid = implicit_eid
        self._last: Optional[HostCopy] = None   # the latest [4] counts
        self._counts_host: Optional[Tuple[int, ...]] = None
        self._dims: Optional[Tuple[int, int]] = None

    @staticmethod
    def _bucket(want: int, cap: int) -> int:
        b = 8192
        while b < want:
            b = -(-int(b * 1.25) // 8192) * 8192
        return min(b, cap)

    def _counts(self) -> Optional[Tuple[int, ...]]:
        """The counts of the latest march whose copy has landed, taken to
        the host once: lattice (n_cells_total, n_verts_total, n_verts,
        n_cells), indexed (n_cells_total, n_tris_total, n_verts, n_tris).
        Never waits but for the first march's: :meth:`pack` runs right
        after :meth:`__call__` stamped this frame's counts, so waiting here
        would chain every frame's dispatch to its own march. Until a newer
        copy lands the last counts serve; the packed header still reports
        an overflow."""
        last = self._last
        if last is not None and (self._counts_host is None or last.ready()):
            self._counts_host = tuple(int(v) for v in last.wait().tolist())
            self._last = None
        return self._counts_host

    def _sizes(self) -> Tuple[int, int, int]:
        """(cell, triangle, vertex) buffer sizes for the next march."""
        c = self._counts()
        if c is None:
            return self.caps
        if self.codec == "lattice":
            ncells, nverts = c[0], c[1]
            if ncells <= 0 or nverts <= 0 or ncells > self.caps[0] \
                    or nverts > self.caps[2]:
                return self.caps                   # overflow -> reset
            return (self._bucket(int(ncells * self.headroom), self.caps[0]),
                    self.caps[1],
                    self._bucket(int(nverts * self.headroom), self.caps[2]))
        ncells, ntris = c[0], c[1]
        if ncells <= 0 or ntris <= 0 or ncells > self.caps[0] \
                or ntris > self.caps[1]:
            return self.caps                       # overflow -> reset
        # ~1 shared vertex per 2 triangles
        return (self._bucket(int(ncells * self.headroom), self.caps[0]),
                self._bucket(int(ntris * self.headroom), self.caps[1]),
                self._bucket(int(ntris * 0.75 * self.headroom),
                             self.caps[2]))

    @torch.no_grad()
    def __call__(self, occ: torch.Tensor,
                 coarse_occ: Optional[torch.Tensor] = None):
        mc, mt, mv = self._sizes()
        if self.virtual:
            # occ IS the coarse grid; the fine dims derive from it
            Dc, Hc, Wc = occ.shape
            self._dims = (2 * Hc - 2, 2 * Wc - 2)
            out = marching_lattice_virtual(occ, iso=self.iso, max_cells=mc,
                                           max_verts=mv,
                                           max_candidates=self.caps[0])
            self._last = HostCopy(torch.stack([
                out.n_cells_total, out.n_verts_total, out.n_verts,
                out.n_cells]))
            return out
        if self.slice_one:
            occ = occ[1:, 1:, 1:]
        self._dims = (occ.shape[1], occ.shape[2])
        coarse_occ = coarse_occ if self.use_coarse else None
        # the candidate (pre-filter) buffer stays at the cap: the autotuned
        # mc tracks the smaller exact mixed set
        if self.codec == "lattice":
            out = marching_lattice(occ, iso=self.iso, max_cells=mc,
                                   max_verts=mv, coarse_occ=coarse_occ,
                                   max_candidates=self.caps[0])
            self._last = HostCopy(torch.stack([
                out.n_cells_total, out.n_verts_total, out.n_verts,
                out.n_cells]))
        else:
            out = marching_tetrahedra_indexed(
                occ, iso=self.iso, max_cells=mc, max_tris=mt,
                max_verts=mv, coarse_occ=coarse_occ,
                max_candidates=self.caps[0])
            self._last = HostCopy(torch.stack([
                out.n_cells_total, out.n_tris_total, out.n_verts,
                out.n_tris]))
        return out

    def pack(self, out, quantize: bool = True):
        """Device-side pack sized from the landed counts x headroom (first
        frame: the full buffers) in this marcher's codec (``quantize``: the
        indexed wire's fixed point), its copy to pinned host memory started
        at once. A lattice on the card is decoded there instead
        (``lattice_decode``: the host decoder's mesh in one buffer, through
        the emit's rank tables, which a repack reads again), and that
        buffer is copied. Waits for nothing past the first frame's
        counts, so a serving loop can enqueue the next frame before this
        one's copy lands. Returns a token for :meth:`decode` and
        :meth:`unpack`: ``((copy, n0, n1), out, meta)``, ``copy`` the
        buffer's :class:`~icon_tpu_torch.recon.engine.HostCopy`."""
        c = self._counts()
        if self.codec == "lattice" and out.vert_eid.device.type == "cuda":
            # the decoded mesh: at most 12 faces (6 tets x 2) a cell
            sizes = (int(c[1] * self.headroom),
                     int(12 * c[0] * self.headroom)) if c is not None \
                else None
            nvb, nfb = _pack_rows(sizes, decode_sizes(out))
            buf = lattice_decode(out, nvb, nfb)
            return (HostCopy(buf), nvb, nfb), out, _DECODED
        if self.codec == "lattice":
            sizes = (int(c[1] * self.headroom),
                     int(c[0] * self.headroom)) if c is not None else None
            buf, n0, n1 = pack_lattice(out, sizes=sizes,
                                       implicit_eid=self.implicit_eid)
            meta = self._dims
        else:
            sizes = (int(c[2] * self.headroom), int(c[3] * self.headroom)) \
                if c is not None else None
            buf, n0, n1 = pack_mesh(out, quantize=quantize, sizes=sizes)
            meta = quantize
        return (HostCopy(buf), n0, n1), out, meta

    def decode(self, token) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Host side of a :meth:`pack` token: waits for its copy to land
        and reads the mesh from the host bytes (a mesh decoded on the card
        is sliced; a lattice wire goes through the host decoder). Returns
        (verts, faces, overflow), the overflow flag set when the frame
        outgrew the packed sizes (the mesh is then truncated:
        :meth:`repack`). Launches nothing on the device, so a worker thread
        may run it while another dispatches."""
        (buf, n0, n1), _, meta = token
        if isinstance(buf, HostCopy):
            buf = buf.wait().numpy()
        if meta is _DECODED:
            return unpack_decoded(buf, n0, n1)
        if self.codec == "lattice":
            H, W = meta
            return decode_lattice((buf, n0, n1), H, W, return_overflow=True)
        return unpack_mesh((buf, n0, n1), quantize=meta,
                           return_overflow=True)

    def repack(self, token) -> Tuple[np.ndarray, np.ndarray]:
        """The token's mesh packed anew at the full buffers (a mesh decoded
        on the card: at its header's true counts), copied and decoded,
        blocking: for a frame whose counts outgrew the packed sizes (the
        one place a frame waits for the card). Launches device work: run
        it on the dispatching thread."""
        (buf, _, _), out, meta = token
        if meta is _DECODED:
            host = buf.wait() if isinstance(buf, HostCopy) else buf
            nv, nf = int(host[0]), int(host[1])
            verts, faces, _ = unpack_decoded(
                lattice_decode(out, nv, nf).cpu(), nv, nf)
            return verts, faces
        if self.codec == "lattice":
            H, W = meta
            return decode_lattice(pack_lattice(out), H, W)
        return unpack_mesh(pack_mesh(out, quantize=meta), quantize=meta)

    def unpack(self, token) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`decode`, waiting for the copy; a frame that outgrew the
        packed sizes re-packs at full size (:meth:`repack`)."""
        verts, faces, overflow = self.decode(token)
        if overflow:
            return self.repack(token)
        return verts, faces
