"""Screened Poisson surface reconstruction on a regular grid
(``icon_tpu.ops.poisson``; it replaces the reference's pymeshlab
``possion``, lib/dataset/mesh_util.py:123-133,
``surface_reconstruction_screened_poisson(depth=10)``).

1. oriented samples: area-stratified points on the faces, each carrying
   its face normal weighted by its share of the face's area
   (:func:`sample_surface`, host numpy, a copy of the JAX function);
2. the normal field V splats trilinearly into a ``[R, R, R, 3]`` grid, the
   sample weights into ``W``;
3. ``(div grad - screen W) chi = div V`` is solved by conjugate gradients
   for ``cg_iters`` iterations (``5 R`` by default); the stencils use
   edge-clamped (Neumann) boundaries, since a periodic roll would couple
   opposite faces of the box;
4. the surface is the level set of ``chi`` at the sample-weighted mean,
   extracted by ``recon/export.py`` and mapped back to the input's frame.

Steps 2-4 are plain PyTorch on the caller's device: the JAX package has no
Pallas kernel here. The CG takes every one of its ``cg_iters`` iterations
without a host read: as in ``jax.scipy.sparse.linalg.cg``, the iterate
stops changing once the squared residual falls to ``1e-10`` of ``|b|^2``
(relative tolerance 1e-5), here by a mask instead of a loop exit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

CG_TOL = 1e-5          # jax.scipy.sparse.linalg.cg's default relative tol


def _corners(points01: torch.Tensor, res: int):
    """The 8 trilinear corners of unit-cube points: yields (flat index
    into ``[res^3]``, weight ``[N]``) in the JAX function's order."""
    p = torch.clamp(points01, 0.0, 1.0) * (res - 1)
    i0 = torch.clamp(torch.floor(p).to(torch.int64), 0, res - 2)
    f = p - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                idx = ((i0[:, 0] + dx) * res + i0[:, 1] + dy) * res + \
                    i0[:, 2] + dz
                yield idx, w


def _splat(points01: torch.Tensor, values: torch.Tensor, res: int
           ) -> torch.Tensor:
    """Trilinear scatter of ``values [N, C]`` at ``points01 [N, 3]`` (unit
    cube) into a ``[res, res, res, C]`` grid."""
    grid = values.new_zeros((res ** 3, values.shape[-1]))
    for idx, w in _corners(points01, res):
        grid.index_add_(0, idx, w[:, None] * values)
    return grid.view(res, res, res, -1)


def _sample(grid: torch.Tensor, points01: torch.Tensor) -> torch.Tensor:
    """Trilinear gather from ``grid [R, R, R]`` at unit-cube points."""
    flat = grid.reshape(-1)
    out = 0.0
    for idx, w in _corners(points01, grid.shape[0]):
        out = out + w * flat[idx]
    return out


def _shift(x: torch.Tensor, ax: int, d: int) -> torch.Tensor:
    """Neighbour in +-``ax`` with edge-clamped (Neumann) boundaries."""
    n = x.shape[ax]
    if d > 0:
        return torch.cat([x.narrow(ax, 1, n - 1), x.narrow(ax, n - 1, 1)],
                         ax)
    return torch.cat([x.narrow(ax, 0, 1), x.narrow(ax, 0, n - 1)], ax)


def _div(v: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of ``v [R, R, R, 3]`` (unit spacing)."""
    out = 0.0
    for ax in range(3):
        out = out + 0.5 * (_shift(v[..., ax], ax, 1)
                           - _shift(v[..., ax], ax, -1))
    return out


def _laplace(x: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian, Neumann boundaries."""
    out = -6.0 * x
    for ax in range(3):
        out = out + _shift(x, ax, 1) + _shift(x, ax, -1)
    return out


def conjugate_gradient(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """``jax.scipy.sparse.linalg.cg(matvec, b, x0=0, maxiter=iters)``:
    ``iters`` iterations from 0, each a no-op once ``r.r <= CG_TOL^2 b.b``
    (a mask, so no iteration reads the device's state on the host)."""
    atol2 = CG_TOL ** 2 * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = torch.sum(r * r)
    for _ in range(iters):
        live = gamma > atol2
        ap = matvec(p)
        alpha = gamma / torch.sum(p * ap)
        x = torch.where(live, x + alpha * p, x)
        r_new = r - alpha * ap
        gamma_new = torch.sum(r_new * r_new)
        p_new = r_new + (gamma_new / gamma) * p
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        gamma = torch.where(live, gamma_new, gamma)
    return x


def sample_surface(verts: np.ndarray, faces: np.ndarray,
                   per_area: float, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-stratified oriented samples: ~``per_area`` samples per unit
    area per face (>= 1 each), barycentric-uniform, each carrying the face
    normal weighted by area/count so the splatted field integrates the
    surface measure. Returns (points [N, 3], weighted_normals [N, 3])."""
    rng = np.random.RandomState(seed)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area2 = np.linalg.norm(fn, axis=1)
    counts = np.maximum(np.ceil(per_area * 0.5 * area2).astype(np.int64), 1)
    fidx = np.repeat(np.arange(len(faces)), counts)
    u = rng.rand(len(fidx), 2).astype(np.float32)
    flip = u.sum(1) > 1
    u[flip] = 1.0 - u[flip]
    t = tri[fidx]
    pts = (t[:, 0] * (1 - u[:, :1] - u[:, 1:])
           + t[:, 1] * u[:, :1] + t[:, 2] * u[:, 1:])
    w = (0.5 * area2[fidx] / counts[fidx])[:, None]
    n = fn[fidx] / np.maximum(area2[fidx][:, None], 1e-12)
    return pts.astype(np.float32), (n * w).astype(np.float32)


def poisson_reconstruct(verts: np.ndarray, faces: np.ndarray,
                        res: int = 128, screen: float = 4.0,
                        cg_iters: Optional[int] = None, pad: float = 0.08,
                        max_cells: int = 1 << 18, max_tris: int = 1 << 19,
                        device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Watertight surface (verts [V, 3] float32, faces [F, 3] int64) of an
    (arbitrarily dirty) input mesh, in the input's frame, solved on
    ``device`` (the card unless the caller asks for the CPU). ``screen``
    weights the data term at the samples (0: plain Poisson); ``cg_iters``
    defaults to ``5 * res`` (the Laplacian's condition number grows as
    ``res^2``)."""
    from icon_tpu_torch.recon.export import extract_mesh

    if cg_iters is None:
        cg_iters = 5 * res
    dev = torch.device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces)
    lo = verts.min(0)
    hi = verts.max(0)
    size = float((hi - lo).max()) * (1.0 + 2.0 * pad)
    origin = (lo + hi) / 2.0 - size / 2.0

    # ~2 samples per surface cell so the splatted field has no holes
    cell = size / res
    pts, wnrm = sample_surface(verts, faces, per_area=2.0 / (cell * cell))
    p01 = torch.as_tensor((pts - origin) / size, device=dev)
    # area weights -> per-index-unit field density: a flat patch through a
    # cell carries ~cell^2 of area and must read |V| ~= 1 so the indicator
    # jumps by ~1 across one grid step (chi solves in index units)
    nrm = torch.as_tensor(wnrm / (cell * cell), device=dev)
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)

    field = _splat(p01, nrm, res)                            # normal field
    wgt = _splat(p01, nlen, res)[..., 0]
    wgt = wgt / torch.clamp(wgt.mean(), min=1e-12)
    chi = conjugate_gradient(lambda x: _laplace(x) - screen * wgt * x,
                             _div(field), cg_iters)
    iso = torch.sum(_sample(chi, p01) * nlen[:, 0]) / \
        torch.clamp(torch.sum(nlen[:, 0]), min=1e-12)
    # orient: chi at the (padded, outside) corner must read "outside"
    # whatever the input's normal orientation
    sgn = -1.0 if float(chi[0, 0, 0]) > float(iso) else 1.0
    # extract_mesh takes [z, y, x] occupancy at iso 0.5, vertices
    # normalized to [-1, 1] over the grid; remap into the input frame
    occ = (sgn * (chi - iso)).permute(2, 1, 0) + 0.5
    v_out, f_out = extract_mesh(occ.contiguous(), max_cells=max_cells,
                                max_tris=max_tris)
    if len(v_out):
        v_out = (v_out * 0.5 + 0.5) * size + origin
    return np.asarray(v_out, np.float32), np.asarray(f_out)
