"""Host side of the lattice wire: the marching-tetrahedra tables and the
decode (copies of ``icon_tpu.recon.marching``'s ``_host_tables``,
``_host_tables_flat`` and ``decode_lattice``, whose module imports jax).

The decode runs in the port's host C++ decoder (``csrc/latticecodec.cc``,
a copy of the JAX package's), built by ``g++`` at first use
(``kernels/build.py:build_host``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# cube corner c -> offset (x, y, z)
_CORNER_OFF = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], np.int32)

# Kuhn 6-tet subdivision: paths 0 -> a -> b -> 7 along cube edges
_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
    [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7],
], np.int32)


@functools.lru_cache(maxsize=1)
def _tet_tables():
    """Per-(tet, case) triangles: (A, B [6, 16, 2, 3] local corner ids of
    each triangle vertex's edge endpoints (inside, outside), valid
    [6, 16, 2] bool), wound counter-clockwise seen from the outside."""
    A = np.zeros((6, 16, 2, 3), np.uint8)
    B = np.zeros((6, 16, 2, 3), np.uint8)
    valid = np.zeros((6, 16, 2), bool)
    for t, tet in enumerate(_TETS):
        pos = _CORNER_OFF[tet].astype(np.float64)        # [4, 3]
        for case in range(1, 15):
            inside = [i for i in range(4) if case & (1 << i)]
            outside = [i for i in range(4) if not case & (1 << i)]
            if len(inside) == 1:
                e = [(inside[0], o) for o in outside]
                tris = [(e[0], e[1], e[2])]
            elif len(inside) == 3:
                e = [(i, outside[0]) for i in inside]
                tris = [(e[0], e[1], e[2])]
            else:
                i0, i1 = inside
                o0, o1 = outside
                a, b, c, d = ((i0, o0), (i0, o1), (i1, o1), (i1, o0))
                tris = [(a, b, c), (a, c, d)]
            outward = pos[outside].mean(0) - pos[inside].mean(0)
            for k, tri in enumerate(tris):
                mids = np.array([(pos[i] + pos[o]) / 2 for i, o in tri])
                n = np.cross(mids[1] - mids[0], mids[2] - mids[0])
                order = (0, 1, 2) if np.dot(n, outward) >= 0 else (0, 2, 1)
                for j, oj in enumerate(order):
                    i_loc, o_loc = tri[oj]
                    A[t, case, k, j] = tet[i_loc]
                    B[t, case, k, j] = tet[o_loc]
                valid[t, case, k] = True
    return A, B, valid


@functools.lru_cache(maxsize=1)
def _host_tables():
    """(tet_case [256, 6] u8: per-tet 4-bit case for each 8-bit corner
    config; corners [96, 2, 3, 2] u8: local corner ids (a, b) per
    (tet*16+case, tri, vert); valid [96, 2] bool)."""
    tet_case = np.zeros((256, 6), np.uint8)
    for bits in range(256):
        for t, tet in enumerate(_TETS):
            c = 0
            for i in range(4):
                if bits >> int(tet[i]) & 1:
                    c |= 1 << i
            tet_case[bits, t] = c
    A, B, tri_valid = _tet_tables()
    corners = np.stack([A, B], axis=-1).reshape(96, 2, 3, 2)
    valid = tri_valid.reshape(96, 2)
    return tet_case, corners, valid


@functools.lru_cache(maxsize=1)
def _host_tables_flat():
    """Flat u8 tables for the native decoder: per-slot min-corner local ids
    and direction codes instead of corner pairs."""
    tet_case, corners, valid = _host_tables()
    a = corners[..., 0].astype(np.int64)        # [96, 2, 3] local ids
    b = corners[..., 1].astype(np.int64)
    offs = _CORNER_OFF                          # [8, 3] (x, y, z)

    def zyx_key(c):
        return (offs[c][..., 2] << 2) | (offs[c][..., 1] << 1) | offs[c][..., 0]

    lo = np.where(zyx_key(a) <= zyx_key(b), a, b).astype(np.uint8)
    d = np.abs(offs[a] - offs[b])
    dcode = (d[..., 0] + 2 * d[..., 1] + 4 * d[..., 2]).astype(np.uint8)
    return (np.ascontiguousarray(tet_case.reshape(-1)),
            np.ascontiguousarray(lo.reshape(-1)),
            np.ascontiguousarray(dcode.reshape(-1)),
            np.ascontiguousarray(valid.reshape(-1).astype(np.uint8)))


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the host decoder."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build_host
            lib = ctypes.CDLL(build_host())
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for fn in (lib.icon_lattice_decode,
                       lib.icon_lattice_decode_implicit):
                fn.argtypes = [vp, ll, ll, ci, ci] + [vp] * 7
                fn.restype = ll
            _lib = lib
    return _lib


def lattice_decode(buf: np.ndarray, nvb: int, ncb: int, H: int, W: int,
                   implicit: bool):
    """(verts [n, 3] f32 grid coords, faces [m, 3] i32, info [3] i32:
    n_verts, n_cells, overflow) of a lattice-codec buffer, through the host
    decoder; ``implicit`` selects wire v2 (no edge-id block)."""
    lib = _load()
    buf = np.ascontiguousarray(buf, np.int32)
    verts = np.empty((nvb, 3), np.float32)
    faces = np.empty((ncb * 12, 3), np.int32)
    info = np.zeros(3, np.int32)
    fn = lib.icon_lattice_decode_implicit if implicit \
        else lib.icon_lattice_decode
    tables = _host_tables_flat()
    nf = fn(buf.ctypes.data, nvb, ncb, H, W,
            *(t.ctypes.data for t in tables), verts.ctypes.data,
            faces.ctypes.data, info.ctypes.data)
    if nf < 0:
        raise ValueError(f"malformed lattice buffer sizes: {nvb} vertex "
                         f"and {ncb} cell slots for a {H}x{W} grid")
    return verts[:info[0]], faces[:nf], info


def decode_lattice(packed, H: int, W: int, return_overflow: bool = False):
    """Blocking transfer + host rebuild of a ``pack_lattice`` buffer: verts
    from (edge id, fraction), faces from (cell id, corner bits). ``H``/``W``
    are the marched grid's dims. Returns (verts [V, 3] f32 grid coords,
    faces [F, 3] int64) (+ the overflow flag: the true counts exceeded the
    packed sizes, so the caller re-packs at full size). The wire format (v1
    explicit edge ids, v2 implicit) is read from header word 2."""
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    if packed is None:
        return empty + (False,) if return_overflow else empty
    buf, nvb, ncb = packed
    host = buf.cpu().numpy() if hasattr(buf, "cpu") else np.asarray(buf)
    implicit = bool(host[2] & 1)
    verts, faces, info = lattice_decode(host, nvb, ncb, H, W, implicit)
    out = (verts, faces.astype(np.int64))
    return out + (bool(info[2]),) if return_overflow else out


def _build_edge_slots():
    """The 19 (lo corner, hi corner, direction) edge slots a cell can own:
    every Kuhn-tet edge (o, o + d) with o + d <= 1 per axis. Interior cells
    own the 7 edges rooted at their origin; cells on a max boundary also
    own the o != 0 edges whose lo lattice point has no cell of its own."""
    slots = []
    for o in range(8):
        for d in range(1, 8):
            hi = ((o & 1) + (d & 1), ((o >> 1) & 1) + ((d >> 1) & 1),
                  ((o >> 2) & 1) + ((d >> 2) & 1))
            if max(hi) <= 1:
                slots.append((o, hi[0] | (hi[1] << 1) | (hi[2] << 2), d))
    assert len(slots) == 19
    return np.array(slots, np.int32)


_EDGE_SLOTS = _build_edge_slots()
