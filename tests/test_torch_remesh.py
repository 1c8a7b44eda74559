"""The port's copy of the isotropic remesher (icon_tpu_torch.ops.remesh) is
the JAX package's (icon_tpu.ops.remesh) exactly: identical vertices and
faces, step by step and whole, on a marched mesh of the clothed-human field
(the input the demo gives it)."""

import numpy as np
import pytest
import torch

from icon_tpu.ops import remesh as jremesh
from icon_tpu_torch.ops import remesh as premesh


@pytest.fixture(scope="module")
def marched():
    """A cleaned mesh of clothed_human_occ marched at res 64, in world
    coordinates, as the fit frame hands it to remesh."""
    from icon_tpu.utils.io import clean_mesh
    from icon_tpu_torch.recon.engine import (ReconEngine,
                                             reconstruction_resolutions)
    from icon_tpu_torch.recon.export import extract_mesh
    from icon_tpu_torch.utils.synthetic import clothed_human_occ
    engine = ReconEngine(reconstruction_resolutions(64), device="cpu")
    with torch.no_grad():
        occ, _ = engine(lambda p: clothed_human_occ(p)[..., None])
    verts, faces = extract_mesh(occ)
    verts, faces = clean_mesh(verts * np.array([1, -1, 1], np.float32),
                              faces)
    assert len(faces) > 5000
    return verts.astype(np.float32), faces


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("step", ["split_long_edges", "collapse_short_edges",
                                  "flip_edges", "tangential_relax",
                                  "taubin_smooth", "vertex_normals"])
def test_remesh_steps_identical(marched, step):
    from icon_tpu.data.datasets import vertex_normals_np
    v, f = marched
    e = premesh.mesh_edges_np(f)
    mean_len = float(np.linalg.norm(v[e[:, 0]] - v[e[:, 1]], axis=1).mean())
    if step == "vertex_normals":
        np.testing.assert_array_equal(premesh.vertex_normals_np(v, f),
                                      vertex_normals_np(v, f))
        return
    args = {"split_long_edges": (v, f, mean_len),
            "collapse_short_edges": (v, f, mean_len),
            "flip_edges": (v, f), "tangential_relax": (v, f),
            "taubin_smooth": (v, f)}[step]
    got = getattr(premesh, step)(*args)
    want = getattr(jremesh, step)(*args)
    _same(got if isinstance(got, tuple) else (got,),
          want if isinstance(want, tuple) else (want,))


@pytest.mark.parametrize("target_len,max_iters", [(0.0, 3), (0.02, 1)])
def test_remesh_identical(marched, target_len, max_iters):
    v, f = marched
    got = premesh.remesh(v, f, target_len=target_len, max_iters=max_iters)
    want = jremesh.remesh(v, f, target_len=target_len, max_iters=max_iters)
    _same(got, want)
    assert got[1].dtype == want[1].dtype and len(got[1]) > 1000
    assert len(got[1]) != len(f)                # it did remesh
