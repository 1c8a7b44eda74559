"""TetraSMPL assets (``tetra_{sex}_{age}_smpl.npz``) from a SMPL release
pickle (``icon_tpu.apps.tetrahedronize``; it replaces the reference's
offline tetgen pipeline, scripts/tetrahedronize_scripts/
tedrahedronize.py).

The body is tetrahedralized in its rest pose, where SMPL's template
already keeps the limbs apart, so the reference's intersection fixing and
un-posing are not needed:

1. interior nodes: a regular lattice kept where the exact ray-parity test
   (``ops/sdf_fast.py:ray_parity_inside_np``) puts it inside, at least half
   a step from the nearest surface vertex;
2. Delaunay over the surface vertices and interior nodes (scipy), keeping
   the tetrahedra whose centroid lies inside and whose longest edge is
   short (which drops the hull's slivers across concavities such as the
   gap between the legs): an unconstrained stand-in for tetgen's conforming
   mesh, enough for PaMIR's voxelization of the node codes;
3. each node's skinning weights, shape and pose blend directions by the
   reference's Gaussian nearest-neighbour transfer
   (tedrahedronize.py:74-92).

The npz has the reference's keys (``v_template_added``, ``weights_added``,
``shapedirs_added``, ``posedirs_added``, ``tetrahedrons``), so
``models/smplx/tetra.py:load_tetra_body_model`` reads it. Everything runs
on the host (numpy and scipy); the functions are copies of the JAX
module's.

    python -m icon_tpu_torch.apps.tetrahedronize \
        -models data/smpl_related/models/smpl -out data/tedra_data
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Tuple

import numpy as np


def interior_nodes(verts: np.ndarray, faces: np.ndarray,
                   spacing: float) -> np.ndarray:
    """Regular lattice points strictly inside the surface, at least
    ``spacing/2`` away from the nearest surface vertex."""
    from scipy.spatial import cKDTree
    from icon_tpu_torch.ops.sdf_fast import ray_parity_inside_np

    lo = verts.min(0) + spacing * 0.25
    hi = verts.max(0) - spacing * 0.25
    axes = [np.arange(lo[k], hi[k], spacing) for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    inside = ray_parity_inside_np(pts, verts, faces)
    pts = pts[inside]
    d, _ = cKDTree(verts).query(pts)
    return pts[d > 0.5 * spacing]


def tetrahedralize(verts: np.ndarray, faces: np.ndarray,
                   spacing: float = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(added_nodes [A, 3], tets [T, 4] int32 indexing verts+added)."""
    from scipy.spatial import Delaunay
    from icon_tpu_torch.ops.sdf_fast import ray_parity_inside_np

    if spacing is None:
        tri = verts[faces]
        spacing = 1.5 * float(np.linalg.norm(
            tri[:, 1] - tri[:, 0], axis=1).mean())
    added = interior_nodes(verts, faces, spacing)
    pts = np.concatenate([verts, added]).astype(np.float64)
    tets = Delaunay(pts).simplices.astype(np.int32)

    cent = pts[tets].mean(1).astype(np.float32)
    inside = ray_parity_inside_np(cent, verts, faces)
    edges = pts[tets]                                    # [T, 4, 3]
    pairs = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    emax = np.max(np.stack([
        np.linalg.norm(edges[:, a] - edges[:, b], axis=1)
        for a, b in pairs]), axis=0)
    keep = inside & (emax < 2.5 * spacing)
    return added.astype(np.float32), tets[keep]


def transfer_weights(added: np.ndarray, verts: np.ndarray,
                     weights: np.ndarray, shapedirs: np.ndarray,
                     posedirs: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian nearest-neighbor transfer (tedrahedronize.py:74-92):
    neighbors within 2x the min distance, gaussian-weighted by that min."""
    from scipy.spatial import cKDTree
    tree = cKDTree(verts)
    w_out = np.zeros((len(added), weights.shape[1]), np.float32)
    s_out = np.zeros((len(added),) + shapedirs.shape[1:], np.float32)
    p_out = np.zeros((len(added),) + posedirs.shape[1:], np.float32)
    # kNN bound: the 2*min-dist ball rarely holds >32 verts at SMPL density
    d, idx = tree.query(added, k=min(32, len(verts)))
    for i in range(len(added)):
        mind = d[i, 0]
        sel = d[i] < 2.0 * mind
        nw = np.exp(-d[i][sel] ** 2 / (2.0 * mind * mind + 1e-12))
        nw = (nw / nw.sum()).astype(np.float32)
        ii = idx[i][sel]
        w_out[i] = nw @ weights[ii]
        s_out[i] = np.tensordot(nw, shapedirs[ii], axes=1)
        p_out[i] = np.tensordot(nw, posedirs[ii], axes=1)
    return w_out, s_out, p_out


def build_tetra_npz(v_template: np.ndarray, faces: np.ndarray,
                    weights: np.ndarray, shapedirs: np.ndarray,
                    posedirs: np.ndarray, out_path: str = None,
                    spacing: float = None) -> dict:
    """Full asset build for one body; returns the npz dict (and writes it
    when ``out_path`` is given)."""
    added, tets = tetrahedralize(v_template, faces, spacing)
    w, s, p = transfer_weights(added, v_template, weights, shapedirs,
                               posedirs)
    out = {
        "v_template_added": added,
        "weights_added": w,
        "shapedirs_added": s,
        "posedirs_added": p,
        "tetrahedrons": tets.astype(np.int32),
    }
    if out_path:
        np.savez_compressed(out_path, **out)
    return out


def main(argv=None) -> dict:
    """Build the npz of every ``SMPL_{MALE,FEMALE,NEUTRAL}.pkl`` under
    ``-models``; returns ``{sex: path written}``."""
    ap = argparse.ArgumentParser(prog="icon_tpu_torch.apps.tetrahedronize")
    ap.add_argument("-models", required=True,
                    help="dir with SMPL_{GENDER}.pkl files")
    ap.add_argument("-out", required=True, help="output tedra_data dir")
    ap.add_argument("-spacing", type=float, default=None,
                    help="interior lattice spacing (default ~1.5x mean "
                         "edge length)")
    args = ap.parse_args(argv)

    import pickle
    os.makedirs(args.out, exist_ok=True)
    written = {}
    for sex in ("male", "female", "neutral"):
        path = osp.join(args.models, f"SMPL_{sex.upper()}.pkl")
        if not osp.exists(path):
            print(f"[tetra] no {path}, skipping")
            continue
        # raw pkl layout (the same arrays tetra.load_tetra_body_model
        # concatenates): posedirs [V, 3, P], shapedirs [V, 3, B]
        with open(path, "rb") as f:
            params = pickle.load(f, encoding="latin1")

        def to_np(x):
            if hasattr(x, "todense"):
                x = x.todense()
            return np.asarray(x, np.float32)

        v = to_np(params["v_template"])
        out_path = osp.join(args.out, f"tetra_{sex}_adult_smpl.npz")
        res = build_tetra_npz(
            v, np.asarray(params["f"], np.int64),
            to_np(params["weights"]),
            to_np(params["shapedirs"])[..., :10],
            to_np(params["posedirs"]), out_path,
            spacing=args.spacing)
        print(f"[tetra] {sex}: +{len(res['v_template_added'])} nodes, "
              f"{len(res['tetrahedrons'])} tets -> {out_path}")
        written[sex] = out_path
    return written


if __name__ == "__main__":
    main()
