"""The indexed marcher's CUDA kernels (``mt_emit``, ``mt_index``) against
their plain PyTorch twins, on the card.

The kernels round each vertex's arithmetic as the plain version does and
every slot of one lattice edge computes its point from the edge's inside
corner, so the counts and the faces are identical and the vertices agree
to 1e-6 grid units (in practice bit for bit).

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_marching_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import marching as km
from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
from icon_tpu_torch.recon import export as PE
from icon_tpu_torch.recon import marching as PM

pytestmark = pytest.mark.cuda

V_ATOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the marching kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _grids(n):
    """A lumpy ellipsoid at n^3 and its 2x align_corners upsample."""
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2)
    r = r + 0.08 * np.sin(7 * x) * np.sin(5 * y)
    coarse = torch.from_numpy(
        (1.0 / (1.0 + np.exp((r - 0.8) * 12))).astype(np.float32))
    fine = resize3d_trilinear_align_corners(coarse[None, None],
                                            (2 * n - 1,) * 3)[0, 0]
    return coarse, fine


def _same(out, ref):
    nv, nt = int(ref.n_verts), int(ref.n_tris)
    counts = [int(x) for x in (out.n_verts, out.n_tris, out.n_cells,
                               out.n_tris_total, out.n_cells_total)]
    assert counts == [int(x) for x in (ref.n_verts, ref.n_tris, ref.n_cells,
                                       ref.n_tris_total, ref.n_cells_total)]
    assert torch.equal(out.faces.cpu(), ref.faces)
    for a in ("verts_x", "verts_y", "verts_z"):
        d = (getattr(out, a)[:nv].cpu() - getattr(ref, a)[:nv]).abs()
        assert float(d.max()) <= V_ATOL
    return nv, nt


@pytest.mark.parametrize("n,coarse_path", [(33, False), (33, True),
                                           (65, True), (129, True)])
def test_indexed_marcher_matches_plain(cuda_device, n, coarse_path):
    coarse, fine = _grids(n)
    occ = fine[1:, 1:, 1:].contiguous()
    kw = dict(max_cells=1 << 18, max_tris=1 << 20, max_verts=1 << 20)
    before = (km.launches_emit, km.launches_index)
    out = PM.marching_tetrahedra_indexed(
        occ.to(cuda_device), coarse_occ=coarse.to(cuda_device)
        if coarse_path else None, **kw)
    torch.cuda.synchronize()
    assert (km.launches_emit, km.launches_index) == (before[0] + 1,
                                                     before[1] + 1)
    ref = PM.marching_tetrahedra_indexed(occ, coarse_occ=coarse
                                         if coarse_path else None, **kw)
    nv, nt = _same(out, ref)
    assert nt > 1000 and nv > 500


@pytest.mark.parametrize("max_tris,max_verts", [(5000, 1 << 16),
                                                (1 << 16, 3000)])
def test_overflow_cuts_like_plain(cuda_device, max_tris, max_verts):
    """Past max_tris the triangles are dropped in (cell, slot) order and
    the total still counts them; past max_verts the faces keep their
    ranks and the vertex table its first rows."""
    _, fine = _grids(33)
    occ = fine[1:, 1:, 1:].contiguous()
    kw = dict(max_cells=1 << 15, max_tris=max_tris, max_verts=max_verts)
    out = PM.marching_tetrahedra_indexed(occ.to(cuda_device), **kw)
    ref = PM.marching_tetrahedra_indexed(occ, **kw)
    _same(out, ref)
    assert int(ref.n_tris_total) > int(ref.n_tris) or \
        int(ref.faces.max()) >= max_verts


def test_extract_mesh_on_the_card(cuda_device):
    """The one-shot export (indexed, exact float32 vertices) on the card
    against the CPU's, and both pack wires round-trip."""
    _, fine = _grids(65)
    vg, fg = PE.extract_mesh(fine.to(cuda_device))
    vc, fc = PE.extract_mesh(fine)
    np.testing.assert_array_equal(fg, fc)
    np.testing.assert_allclose(vg, vc, rtol=0, atol=V_ATOL)
    out = PM.marching_tetrahedra_indexed(fine[1:, 1:, 1:].to(cuda_device))
    v0, f0 = PM.fetch_mesh(out, quantize=False)
    v1, f1 = PM.fetch_mesh(out, quantize=True)
    np.testing.assert_array_equal(f0, f1)
    assert np.abs(v0 - v1).max() <= 0.5 / 64 + 1e-6
