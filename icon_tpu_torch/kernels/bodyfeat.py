"""SMPL-local body features at query points: the CUDA kernel and its plain
twin.

:func:`body_features_kernel` is the wrapper
``ops/sdf_fast.py:point_body_features`` calls with the kNN kernel's
``[N, k]`` result. A CUDA tensor launches ``csrc/bodyfeat.cu`` or raises:
first the body's per-face records (:func:`face_records_plain`'s layout,
into a buffer the call owns), then a lane group a point over its
candidate faces in parallel (the exact distances, the first minimum by a
shuffle reduction, the winning face's interpolated attributes and the
sign). A CPU tensor takes :func:`point_body_features_plain`, the same
function in plain PyTorch. The plain version spells out every product and
sum as its own tensor operation, and the kernel rounds each as that
operation does, so the two agree bit for bit on the card;
:func:`record_distances_plain` is the kernel's distance from a record,
bit-equal to :func:`candidate_distances`.

The sign: ``known_inside``, else the column parity of ``cross_z``; without
either both write the unsigned distance and the winning face, and the
caller signs. ``launches_bodyfeat`` counts the calls that launched the
kernels, so a run can show that the main path went through them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from icon_tpu_torch.ops.constants import device_constant

SIGN_UNSIGNED, SIGN_KNOWN, SIGN_COLUMNS = 0, 1, 2
RECORD_WORDS = 16       # a face record: 64 bytes (csrc/bodyfeat.cu)

launches_bodyfeat = 0   # calls that launched the kernels since the last reset

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from icon_tpu_torch.kernels.build import build
            _lib = _bind(build()["bodyfeat.cu"])
    return _lib


def _bind(path: str) -> ctypes.CDLL:
    """The library at ``path`` with its functions' argument types set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(ci)
    lib.icon_bodyfeat_records.argtypes = [vp, vp, ci, vp, vp]
    lib.icon_bodyfeat_records.restype = ci
    lib.icon_body_features.argtypes = [
        vp, ci, vp, ci, vp, vp, ci, ci, vp, vp, vp, ci, vp, vp, ci, vp, vp,
        vp, vp, vp, vp, vp]
    lib.icon_body_features.restype = ci
    lib.icon_bodyfeat_kernel_info.argtypes = [ci, ci, pi, pi, pi, pi, pi,
                                              pi]
    lib.icon_bodyfeat_kernel_info.restype = ci
    lib.icon_bodyfeat_error_string.argtypes = [ci]
    lib.icon_bodyfeat_error_string.restype = ctypes.c_char_p
    return lib


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _cross_fused(ax, ay, az, bx, by, bz):
    """:func:`_cross` with each a1 b2 - a2 b1 rounded as fma(a1, b2, -(a2
    b1)): a1 b2 exact in float64, less the float32 product a2 b1, rounded
    once more to float32 (up to that double rounding, the fused form of the
    CPU's torch.linalg.cross and of XLA's cross in the JAX package, whose
    extrapolated weights amplify a rounding of the cross)."""
    def fused(p, q, r, s):
        return (p.double() * q.double() - (r * s).double()).float()

    return (fused(ay, bz, az, by), fused(az, bx, ax, bz),
            fused(ax, by, ay, bx))


def candidate_distances(points: torch.Tensor, tri_block: torch.Tensor,
                        closest: bool = False):
    """Squared distance [N, C] from ``points [N, 3]`` to each candidate
    triangle of ``tri_block [N, C, 9]`` (the plane projection where it
    falls inside the triangle, else the nearest edge point); with
    ``closest`` also the closest points' coordinates (x, y, z), each
    [N, C]."""
    (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = tri_block.unbind(-1)
    px = points[:, 0:1]
    py = points[:, 1:2]
    pz = points[:, 2:3]

    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    vx, vy, vz = v2x - v0x, v2y - v0y, v2z - v0z
    nx, ny, nz = _cross(ux, uy, uz, vx, vy, vz)
    n2 = torch.clamp(_dot(nx, ny, nz, nx, ny, nz), min=1e-12)
    wx, wy, wz = px - v0x, py - v0y, pz - v0z

    cx, cy, cz = _cross(ux, uy, uz, wx, wy, wz)
    b2 = _dot(cx, cy, cz, nx, ny, nz) / n2
    cx, cy, cz = _cross(wx, wy, wz, vx, vy, vz)
    b1 = _dot(cx, cy, cz, nx, ny, nz) / n2
    b0 = 1.0 - b1 - b2
    inside = (b0 >= 0) & (b0 <= 1) & (b1 >= 0) & (b1 <= 1) & \
        (b2 >= 0) & (b2 <= 1)

    # plane projection closest point
    pn = _dot(wx, wy, wz, nx, ny, nz) / n2
    prx, pry, prz = px - pn * nx, py - pn * ny, pz - pn * nz
    d_in = (px - prx) ** 2 + (py - pry) ** 2 + (pz - prz) ** 2

    def seg(ax_, ay_, az_, bx_, by_, bz_):
        ex, ey, ez = bx_ - ax_, by_ - ay_, bz_ - az_
        sx, sy, sz = px - ax_, py - ay_, pz - az_
        tt = torch.clamp(_dot(sx, sy, sz, ex, ey, ez) /
                         torch.clamp(_dot(ex, ey, ez, ex, ey, ez), min=1e-12),
                         0.0, 1.0)
        qx, qy, qz = ax_ + tt * ex, ay_ + tt * ey, az_ + tt * ez
        return (px - qx) ** 2 + (py - qy) ** 2 + (pz - qz) ** 2, (qx, qy, qz)

    d01, q01 = seg(v0x, v0y, v0z, v1x, v1y, v1z)
    d12, q12 = seg(v1x, v1y, v1z, v2x, v2y, v2z)
    d20, q20 = seg(v2x, v2y, v2z, v0x, v0y, v0z)
    d_edge = torch.minimum(torch.minimum(d01, d12), d20)
    d2 = torch.where(inside, d_in, d_edge)                # [N, C]
    if not closest:
        return d2
    e_first = (d01 <= d12) & (d01 <= d20)
    e_second = (d12 <= d20) & ~e_first
    q = tuple(torch.where(inside, pr, torch.where(
        e_first, a, torch.where(e_second, b, c)))
        for pr, a, b, c in zip((prx, pry, prz), q01, q12, q20))
    return d2, q


def face_records_plain(verts: torch.Tensor,
                       faces: torch.Tensor) -> torch.Tensor:
    """The kernel's per-face records ``[F, 16]`` float32 of ``verts [V,
    3]`` and ``faces [F, 3]``: the corners (v0, v1, v2), the clamped
    squared normal n2, the clamped squared lengths of the edges v0-v1,
    v1-v2 and v2-v0, rounded as :func:`candidate_distances` rounds them,
    and the corner ids' int32 bits."""
    faces = faces.long()
    (v0x, v0y, v0z), (v1x, v1y, v1z), (v2x, v2y, v2z) = (
        verts[faces[:, j]].unbind(-1) for j in range(3))

    def clamped_sq(ex, ey, ez):
        return torch.clamp(_dot(ex, ey, ez, ex, ey, ez), min=1e-12)

    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    n2 = clamped_sq(*_cross(ux, uy, uz, v2x - v0x, v2y - v0y, v2z - v0z))
    ids = faces.int().view(torch.float32).unbind(-1)
    return torch.stack([v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z, n2,
                        clamped_sq(ux, uy, uz),
                        clamped_sq(v2x - v1x, v2y - v1y, v2z - v1z),
                        clamped_sq(v0x - v2x, v0y - v2y, v0z - v2z), *ids],
                       dim=-1)


def record_distances_plain(points: torch.Tensor,
                           rec_block: torch.Tensor) -> torch.Tensor:
    """Squared distance [N, C] from ``points [N, 3]`` to each candidate
    face given by its record, ``rec_block [N, C, 16]``: the kernel's
    reading of :func:`face_records_plain`, the edges, u, v and the cross
    recomputed from the corners. Bit-equal to :func:`candidate_distances`
    on the same faces."""
    (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z, n2, l01, l12,
     l20) = rec_block[..., :13].unbind(-1)
    px = points[:, 0:1]
    py = points[:, 1:2]
    pz = points[:, 2:3]

    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    vx, vy, vz = v2x - v0x, v2y - v0y, v2z - v0z
    nx, ny, nz = _cross(ux, uy, uz, vx, vy, vz)
    wx, wy, wz = px - v0x, py - v0y, pz - v0z
    b2 = _dot(*_cross(ux, uy, uz, wx, wy, wz), nx, ny, nz) / n2
    b1 = _dot(*_cross(wx, wy, wz, vx, vy, vz), nx, ny, nz) / n2
    b0 = 1.0 - b1 - b2
    inside = (b0 >= 0) & (b0 <= 1) & (b1 >= 0) & (b1 <= 1) & \
        (b2 >= 0) & (b2 <= 1)
    pn = _dot(wx, wy, wz, nx, ny, nz) / n2
    d_in = (px - (px - pn * nx)) ** 2 + (py - (py - pn * ny)) ** 2 + \
        (pz - (pz - pn * nz)) ** 2

    def seg(ax_, ay_, az_, ex, ey, ez, length):
        tt = torch.clamp(_dot(px - ax_, py - ay_, pz - az_, ex, ey, ez) /
                         length, 0.0, 1.0)
        return (px - (ax_ + tt * ex)) ** 2 + (py - (ay_ + tt * ey)) ** 2 + \
            (pz - (az_ + tt * ez)) ** 2

    d_edge = torch.minimum(torch.minimum(
        seg(v0x, v0y, v0z, ux, uy, uz, l01),
        seg(v1x, v1y, v1z, v2x - v1x, v2y - v1y, v2z - v1z, l12)),
        seg(v2x, v2y, v2z, v0x - v2x, v0y - v2y, v0z - v2z, l20))
    return torch.where(inside, d_in, d_edge)


def projection_weights(points: torch.Tensor, tri) -> Tuple[torch.Tensor, ...]:
    """Barycentric weights (w0, w1, w2), each [N], of each point's
    projection onto its triangle's plane, unclamped: ``tri`` is the nine
    corner coordinates (v0x, v0y, v0z, v1x, ..., v2z), each [N]; a
    degenerate triangle's squared normal 0 becomes 1e-6, as in
    ops/mesh.py:barycentric_projection_weights. The crosses are
    :func:`_cross_fused`, the sums in order."""
    (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = tri
    px, py, pz = points.unbind(-1)
    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    vx, vy, vz = v2x - v0x, v2y - v0y, v2z - v0z
    nx, ny, nz = _cross_fused(ux, uy, uz, vx, vy, vz)
    s = _dot(nx, ny, nz, nx, ny, nz)
    s = torch.where(s == 0, 1e-6, s)
    wx, wy, wz = px - v0x, py - v0y, pz - v0z
    b2 = _dot(*_cross_fused(ux, uy, uz, wx, wy, wz), nx, ny, nz) / s
    b1 = _dot(*_cross_fused(wx, wy, wz, vx, vy, vz), nx, ny, nz) / s
    return 1.0 - b1 - b2, b1, b2


def column_parity_inside(points: torch.Tensor, cross_z: torch.Tensor,
                         meta: torch.Tensor) -> torch.Tensor:
    """Inside test [N] bool: parity of the crossings above each point in
    its column. meta [6] f32 = (x0, y0, inv_dx, inv_dy, W, H); points off
    the lattice snap to the nearest column."""
    W = meta[4].long()                  # stays on the device: no host sync
    H = meta[5].long()
    ix = torch.minimum(torch.clamp(torch.round(
        (points[:, 0] - meta[0]) * meta[2]).long(), min=0), W - 1)
    iy = torch.minimum(torch.clamp(torch.round(
        (points[:, 1] - meta[1]) * meta[3]).long(), min=0), H - 1)
    col = cross_z[iy * W + ix]                            # [N, C]
    above = (col > points[:, 2:3]).sum(-1)
    return above % 2 == 1


def point_body_features_plain(points: torch.Tensor, nn_idx: torch.Tensor,
                              verts: torch.Tensor, faces: torch.Tensor,
                              vert_face_table: torch.Tensor,
                              normals: torch.Tensor, cmaps: torch.Tensor,
                              vis: torch.Tensor,
                              known_inside: Optional[torch.Tensor] = None,
                              cross_z: Optional[torch.Tensor] = None,
                              cross_meta: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: ``points [N, 3]``, their k
    nearest vertices ``nn_idx [N, k]``, ``verts [V, 3]``, ``faces [F,
    3]``, ``vert_face_table [V, deg]``, vertex ``normals [V, 3]``, ``cmaps
    [V, 3]``, ``vis [V, 1]``. Returns (sdf [N, 1], normal [N, 3], cmap [N,
    3], vis [N, 1], best_face [N] int64): sdf positive inside by
    ``known_inside [N]``, else by the column parity of ``cross_z``/
    ``cross_meta``, else the unsigned distance."""
    N = points.shape[0]
    faces = faces.long()
    C = nn_idx.shape[1] * vert_face_table.shape[1]
    cand = vert_face_table.long()[nn_idx.long()].reshape(N, C)

    packed_tri = torch.cat([verts[faces[:, 0]], verts[faces[:, 1]],
                            verts[faces[:, 2]]], dim=-1)  # [F, 9]
    d2 = candidate_distances(points, packed_tri[cand])    # [N, C]

    best = torch.argmin(d2, dim=1, keepdim=True)          # first minimum
    d2b = torch.gather(d2, 1, best)[:, 0]
    best_face = torch.gather(cand, 1, best)[:, 0]

    # the winning face's attributes, interpolated at the reference's
    # weights: the unclamped plane projection of the raw query point
    # (barycentric_coordinates_of_projection, mesh_util.py:384-391), each
    # product and sum its own tensor operation, in order
    packed_attr = torch.cat(
        [packed_tri] + [normals[faces[:, j]] for j in range(3)] +
        [cmaps[faces[:, j]] for j in range(3)] +
        [vis[faces[:, j]] for j in range(3)], dim=-1)     # [F, 30]
    row = packed_attr[best_face].unbind(-1)               # 30 x [N]
    w = projection_weights(points, row[0:9])

    def interp(lo, width):       # corner j's values at row[lo + width j]
        return [row[lo + c] * w[0] + row[lo + width + c] * w[1] +
                row[lo + 2 * width + c] * w[2] for c in range(width)]

    nx, ny, nz = interp(9, 3)
    normal_q = torch.stack([-nx, ny, -nz], dim=-1)        # flip (-1, 1, -1)
    cmap_q = torch.stack(interp(18, 3), dim=-1)
    vis_q = (interp(27, 1)[0] >= 0.1).to(points.dtype)[:, None]

    dist = torch.sqrt(torch.clamp(d2b, min=0.0)) / device_constant(
        math.sqrt(3.0), points.dtype, points.device)
    if known_inside is not None:
        dist = torch.where(known_inside.bool(), dist, -dist)
    elif cross_z is not None:
        dist = torch.where(column_parity_inside(points, cross_z, cross_meta),
                           dist, -dist)
    return dist[..., None], normal_q, cmap_q, vis_q, best_face


def _check(points, nn_idx, verts, faces, vert_face_table, normals, cmaps,
           vis, known_inside, cross_z, cross_meta) -> None:
    n = points.shape[0]
    V = verts.shape[0]
    shapes = (("points", points, (n, 3)), ("verts", verts, (V, 3)),
              ("normals", normals, (V, 3)), ("cmaps", cmaps, (V, 3)),
              ("vis", vis, (V, 1)))
    for name, t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {want} expected, got "
                             f"{tuple(t.shape)}")
    if nn_idx.ndim != 2 or nn_idx.shape[0] != n or faces.ndim != 2 or \
            faces.shape[1] != 3 or vert_face_table.ndim != 2 or \
            vert_face_table.shape[0] != V:
        raise ValueError(f"nn_idx [N, k], faces [F, 3] and vert_face_table "
                         f"[V, deg] expected, got {tuple(nn_idx.shape)}, "
                         f"{tuple(faces.shape)}, "
                         f"{tuple(vert_face_table.shape)}")
    if known_inside is not None and tuple(known_inside.shape) != (n,):
        raise ValueError(f"known_inside [{n}] expected, got "
                         f"{tuple(known_inside.shape)}")
    if (cross_z is None) != (cross_meta is None):
        raise ValueError("cross_z and cross_meta go together")
    if cross_z is not None and (cross_z.ndim != 2 or
                                tuple(cross_meta.shape) != (6,)):
        raise ValueError(f"cross_z [H*W, C] and cross_meta [6] expected, got "
                         f"{tuple(cross_z.shape)}, "
                         f"{tuple(cross_meta.shape)}")
    for t in (nn_idx, verts, faces, vert_face_table, normals, cmaps, vis,
              known_inside, cross_z, cross_meta):
        if t is not None and t.device != points.device:
            raise ValueError(f"inputs on {t.device} and {points.device}")


def body_features_kernel(points: torch.Tensor, nn_idx: torch.Tensor,
                         verts: torch.Tensor, faces: torch.Tensor,
                         vert_face_table: torch.Tensor,
                         normals: torch.Tensor, cmaps: torch.Tensor,
                         vis: torch.Tensor,
                         known_inside: Optional[torch.Tensor] = None,
                         cross_z: Optional[torch.Tensor] = None,
                         cross_meta: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """(sdf [N, 1], normal [N, 3], cmap [N, 3], vis [N, 1], best_face [N]
    int64) of :func:`point_body_features_plain`.

    CPU tensors take the plain version. CUDA tensors must be contiguous:
    float32 points, body tables and columns, int32 ``nn_idx`` (the kNN
    kernel's), int64 ``faces``, an int32 or int64 table (every id in
    range), bool ``known_inside``, none requiring grad (the kernel has no
    backward); they launch the kernel on the current stream or raise."""
    global launches_bodyfeat
    args = (points, nn_idx, verts, faces, vert_face_table, normals, cmaps,
            vis, known_inside, cross_z, cross_meta)
    _check(*args)
    if points.device.type == "cpu":
        return point_body_features_plain(*args)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    named = dict(zip(("points", "nn_idx", "verts", "faces",
                      "vert_face_table", "normals", "cmaps", "vis",
                      "known_inside", "cross_z", "cross_meta"), args))
    for name, t in named.items():
        if t is None:
            continue
        if t.requires_grad:
            raise RuntimeError(f"{name} requires grad: the body-feature "
                               f"kernel has no backward")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("nn_idx", "faces", "vert_face_table"):
            ok = {"nn_idx": (torch.int32,), "faces": (torch.int64,),
                  "vert_face_table": (torch.int32, torch.int64)}[name]
            if t.dtype not in ok:
                raise TypeError(f"{name} must be "
                                f"{' or '.join(map(str, ok))}, got {t.dtype}")
        elif name == "known_inside":
            if t.dtype != torch.bool:
                raise TypeError(f"known_inside must be bool, got {t.dtype}")
        elif t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    n, k = nn_idx.shape
    if n * k >= 2 ** 31 or n >= 2 ** 31 // 3:
        raise ValueError(f"{n} points x {k} neighbours exceed int32 "
                         f"indexing")
    if max(faces.shape[0], verts.shape[0]) >= 2 ** 31:
        raise ValueError(f"{faces.shape[0]} faces or {verts.shape[0]} "
                         f"vertices exceed the records' int32 ids")
    dev = points.device
    sdf = torch.empty((n, 1), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cmap = torch.empty((n, 3), dtype=torch.float32, device=dev)
    vis_q = torch.empty((n, 1), dtype=torch.float32, device=dev)
    best_face = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            records = _records(lib, stream, verts, faces)
            _features(lib, stream, *args,
                      (sdf, normal, cmap, vis_q, best_face), records)
        launches_bodyfeat += 1
    return sdf, normal, cmap, vis_q, best_face


def face_records(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """The body's face records ``[F, 16]`` (:func:`face_records_plain`):
    on the card one launch of the record kernel into a new buffer on the
    current stream (float32 ``verts``, int64 ``faces``, contiguous, every
    id in range, as :func:`body_features_kernel` checks them); on the CPU
    the plain version. Counts nothing."""
    if verts.device.type == "cpu":
        return face_records_plain(verts, faces)
    lib = _load()
    with torch.cuda.device(verts.device):
        return _records(lib, torch.cuda.current_stream().cuda_stream, verts,
                        faces)


def _launch(points, nn_idx, verts, faces, vert_face_table, normals, cmaps,
            vis, known_inside, cross_z, cross_meta, outs, records) -> None:
    """The body-feature kernel's launch alone into the caller-owned
    ``outs`` (sdf, normal, cmap, vis, best_face) on ``records``, the
    body's :func:`face_records` (inputs checked by the caller, N > 0), on
    the current stream; counts nothing. The tests and the kernel's timing
    use it."""
    lib = _load()
    with torch.cuda.device(points.device):
        _features(lib, torch.cuda.current_stream().cuda_stream, points,
                  nn_idx, verts, faces, vert_face_table, normals, cmaps, vis,
                  known_inside, cross_z, cross_meta, outs, records)


def _records(lib, stream, verts, faces) -> torch.Tensor:
    rec = torch.empty((faces.shape[0], RECORD_WORDS), dtype=torch.float32,
                      device=verts.device)
    _raise_on(lib, lib.icon_bodyfeat_records(
        verts.data_ptr(), faces.data_ptr(), faces.shape[0], rec.data_ptr(),
        stream), "icon_bodyfeat_records launch")
    return rec


def _features(lib, stream, points, nn_idx, verts, faces, vert_face_table,
              normals, cmaps, vis, known_inside, cross_z, cross_meta, outs,
              records) -> None:
    sign = SIGN_KNOWN if known_inside is not None else \
        SIGN_COLUMNS if cross_z is not None else SIGN_UNSIGNED
    sdf, normal, cmap, vis_q, best_face = outs
    err = lib.icon_body_features(
        points.data_ptr(), points.shape[0], nn_idx.data_ptr(),
        nn_idx.shape[1], records.data_ptr(), vert_face_table.data_ptr(),
        vert_face_table.shape[1], int(vert_face_table.dtype == torch.int64),
        normals.data_ptr(), cmaps.data_ptr(), vis.data_ptr(), sign,
        known_inside.data_ptr() if sign == SIGN_KNOWN else None,
        cross_z.data_ptr() if sign == SIGN_COLUMNS else None,
        cross_z.shape[1] if sign == SIGN_COLUMNS else 0,
        cross_meta.data_ptr() if sign == SIGN_COLUMNS else None,
        sdf.data_ptr(), normal.data_ptr(), cmap.data_ptr(),
        vis_q.data_ptr(), best_face.data_ptr(), stream)
    _raise_on(lib, err, "icon_body_features launch")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.icon_bodyfeat_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def kernel_info(n_cand: int) -> dict:
    """The body-feature kernel that ``n_cand`` = k x deg candidates launch
    and the record kernel, on the current card: for each, registers and
    local memory bytes a thread, threads a block, lanes a point, resident
    blocks an SM (the occupancy calculator's), SMs, and the resident
    threads' share of the SM's 2,048 (``occupancy``)."""
    lib = _load()
    out = {}
    for which, name in enumerate(("features", "records")):
        vals = [ctypes.c_int(0) for _ in range(6)]
        _raise_on(lib, lib.icon_bodyfeat_kernel_info(
            which, n_cand, *map(ctypes.byref, vals)),
            "icon_bodyfeat_kernel_info")
        regs, local_bytes, threads, group, per_sm, sms = \
            (v.value for v in vals)
        out[name] = {"registers": regs, "local_bytes": local_bytes,
                     "threads": threads, "lanes_a_point": group,
                     "blocks_per_sm": per_sm, "sms": sms,
                     "occupancy": per_sm * threads / 2048}
    return out
