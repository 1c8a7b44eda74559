"""Port parity, the indexed marcher and the virtual final level:
icon_tpu_torch.recon.marching (``marching_tetrahedra_indexed`` through the
plain versions of ``kernels/marching.py``, ``pack_mesh``,
``unpack_mesh``, ``fetch_mesh``, ``marching_tetrahedra``,
``dedup_triangle_soup``, ``AutoMarcher(codec="indexed")``,
``marching_lattice_virtual``), ``recon/export.py:extract_mesh`` without a
marcher and ``ReconEngine(virtual_final=True)`` against the JAX package on
the same grids.

Tolerances: counts, faces, edge ids, cell ids and corner bits identical;
vertices to 1e-6 grid units and lattice fractions to 1e-6 (both packages
round each vertex's arithmetic the same way; in practice they are bit for
bit equal); packed words identical where they carry data (the rows past
the counts are each package's padding)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu.recon import export as JE
from icon_tpu.recon import marching as JM
from icon_tpu_torch.recon import export as PE
from icon_tpu_torch.recon import marching as PM

V_ATOL = 1e-6
KW = dict(max_cells=1 << 15, max_tris=1 << 16, max_verts=1 << 17)


def _grids(n=33):
    """A lumpy ellipsoid at n^3 and its engine-style 2x upsample (the JAX
    package's resize), for the coarse-candidate and virtual paths."""
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2)
    r = r + 0.08 * np.sin(7 * x) * np.sin(5 * y)
    coarse = (1.0 / (1.0 + np.exp((r - 0.8) * 12))).astype(np.float32)
    from icon_tpu.ops.resize import resize3d_trilinear_align_corners
    fine = np.asarray(resize3d_trilinear_align_corners(
        jnp.asarray(coarse)[None, ..., None], (2 * n - 1,) * 3))[0, ..., 0]
    return coarse, np.ascontiguousarray(fine)


def _same_march(out, ref):
    counts = [int(x) for x in (out.n_verts, out.n_tris, out.n_cells,
                               out.n_tris_total, out.n_cells_total)]
    assert counts == [int(x) for x in (ref.n_verts, ref.n_tris, ref.n_cells,
                                       ref.n_tris_total, ref.n_cells_total)]
    np.testing.assert_array_equal(out.faces.numpy(), np.asarray(ref.faces))
    nv = int(ref.n_verts)
    for a in ("verts_x", "verts_y", "verts_z"):
        np.testing.assert_allclose(getattr(out, a)[:nv].numpy(),
                                   np.asarray(getattr(ref, a))[:nv], rtol=0,
                                   atol=V_ATOL)
    return nv, int(ref.n_tris)


@pytest.mark.parametrize("coarse_path", [False, True])
def test_marching_tetrahedra_indexed_parity(coarse_path):
    coarse, fine = _grids()
    occ = fine[1:, 1:, 1:]
    ref = JM.marching_tetrahedra_indexed(
        jnp.asarray(occ), coarse_occ=jnp.asarray(coarse)
        if coarse_path else None, **KW)
    out = PM.marching_tetrahedra_indexed(
        t(occ), coarse_occ=t(coarse) if coarse_path else None, **KW)
    assert out.faces.dtype == torch.int32
    nv, nt = _same_march(out, ref)
    assert nt > 10000 and nv > 5000


@pytest.mark.parametrize("max_tris,max_verts", [(5000, 1 << 16),
                                                (1 << 16, 3000)])
def test_indexed_overflow_parity(max_tris, max_verts):
    """Past max_tris (the total still counts) and past max_verts (faces
    keep their ranks), as the JAX package cuts them."""
    _, fine = _grids()
    occ = fine[1:, 1:, 1:]
    kw = dict(max_cells=1 << 15, max_tris=max_tris, max_verts=max_verts)
    ref = JM.marching_tetrahedra_indexed(jnp.asarray(occ), **kw)
    out = PM.marching_tetrahedra_indexed(t(occ), **kw)
    _same_march(out, ref)
    assert int(out.n_tris_total) > int(out.n_tris) or \
        int(out.faces.max()) >= max_verts


def _packed_parts(buf, nvb, ntb, nv, nt, quantize):
    """The words of a pack_mesh buffer that carry data: the header, the
    first nv entries of each vertex block and the first nt of each face
    block."""
    b = np.asarray(buf).view(np.int32)
    if quantize:
        nz = (nvb + 1) // 2
        return [b[:2], b[2:2 + nv], b[2 + nvb:2 + nvb + nv // 2],
                b[2 + nvb + nz:2 + nvb + nz + nt],
                b[2 + nvb + nz + ntb:2 + nvb + nz + ntb + nt]]
    return [b[:2], b[2:2 + nv], b[2 + nvb:2 + nvb + nv],
            b[2 + 2 * nvb:2 + 2 * nvb + nv],
            b[2 + 3 * nvb:2 + 3 * nvb + 3 * nt]]


@pytest.mark.parametrize("quantize", [False, True])
def test_pack_mesh_words_identical(quantize):
    _, fine = _grids()
    occ = fine[1:, 1:, 1:]
    ref = JM.marching_tetrahedra_indexed(jnp.asarray(occ), **KW)
    out = PM.marching_tetrahedra_indexed(t(occ), **KW)
    for sizes in (None, (9000, 20000)):
        jbuf, jnv, jnt = JM.pack_mesh(ref, quantize=quantize, sizes=sizes,
                                      bucket=4096)
        buf, nvb, ntb = PM.pack_mesh(out, quantize=quantize, sizes=sizes,
                                     bucket=4096)
        assert (nvb, ntb) == (jnv, jnt) and len(buf) == len(jbuf)
        assert buf.dtype == (torch.int32 if quantize else torch.float32)
        nv, nt = min(int(ref.n_verts), nvb), min(int(ref.n_tris), ntb)
        for a, b in zip(_packed_parts(buf.numpy(), nvb, ntb, nv, nt,
                                      quantize),
                        _packed_parts(np.asarray(jbuf), nvb, ntb, nv, nt,
                                      quantize)):
            np.testing.assert_array_equal(a, b)
        # the decode, the host copy of the JAX function
        got = PM.unpack_mesh((buf, nvb, ntb), quantize=quantize,
                             return_overflow=True)
        want = JM.unpack_mesh((jbuf, jnv, jnt), quantize=quantize,
                              return_overflow=True)
        assert got[2] == want[2] == (sizes is not None)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=V_ATOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_fetch_mesh_and_overflow(quantize):
    """fetch_mesh equals the JAX package's; a pack cut below the counts
    reports the overflow and drops the faces past the copied vertices, as
    the JAX decode does."""
    _, fine = _grids()
    occ = fine[1:, 1:, 1:]
    ref = JM.marching_tetrahedra_indexed(jnp.asarray(occ), **KW)
    out = PM.marching_tetrahedra_indexed(t(occ), **KW)
    v, f = PM.fetch_mesh(out, quantize=quantize)
    vj, fj = JM.fetch_mesh(ref, quantize=quantize)
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, vj, rtol=0, atol=V_ATOL)
    tiny = PM.pack_mesh(out, quantize=quantize, sizes=(64, 64), bucket=64)
    jtiny = JM.pack_mesh(ref, quantize=quantize, sizes=(64, 64), bucket=64)
    got = PM.unpack_mesh(tiny, quantize=quantize, return_overflow=True)
    want = JM.unpack_mesh(jtiny, quantize=quantize, return_overflow=True)
    assert got[2] and want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) and (got[1] < 64).all()


def test_marching_tetrahedra_soup_and_dedup():
    """The soup wrapper equals the JAX package's, and the host dedup of
    that soup gives the JAX dedup's mesh."""
    _, fine = _grids()
    occ = fine[1:, 1:, 1:]
    tri, mask, nc, nt = PM.marching_tetrahedra(t(occ), max_cells=1 << 15,
                                               max_tris=1 << 16)
    jtri, jmask, jnc, jnt = JM.marching_tetrahedra(
        jnp.asarray(occ), max_cells=1 << 15, max_tris=1 << 16)
    assert (int(nc), int(nt)) == (int(jnc), int(jnt))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tri.numpy(), np.asarray(jtri), rtol=0,
                               atol=V_ATOL)
    v, f = PM.dedup_triangle_soup(tri.numpy(), mask.numpy())
    vj, fj = JM.dedup_triangle_soup(np.asarray(jtri), np.asarray(jmask))
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_array_equal(v, vj)
    # the dedup of the soup is the indexed mesh up to vertex order
    vi, fi = PM.fetch_mesh(PM.marching_tetrahedra_indexed(
        t(occ), max_cells=1 << 15, max_tris=1 << 16,
        max_verts=1 << 17))
    assert len(v) == len(vi) and len(f) == len(fi)


def test_extract_mesh_without_marcher_equals_jax():
    """The one-shot export: JAX's indexed mesh with exact float32 vertices,
    not a lattice marcher's u8 fractions (which put vertices up to 1.06e-4
    away in normalized units on this 65^3 grid)."""
    _, fine = _grids()
    vj, fj = JE.extract_mesh(jnp.asarray(fine), max_cells=1 << 15,
                             max_tris=1 << 16)
    vp, fp = PE.extract_mesh(t(fine), max_cells=1 << 15, max_tris=1 << 16)
    assert len(fp) > 10000
    np.testing.assert_array_equal(fp, fj)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=V_ATOL)


def test_automarcher_indexed_over_three_frames():
    """The indexed serving marcher (autotuned buffers, quantized pack sized
    from measured counts) gives the JAX package's meshes frame after
    frame."""
    coarse, fine = _grids()
    kw = dict(max_cells=1 << 15, max_tris=1 << 16, slice_one=True,
              codec="indexed")
    jm = JM.AutoMarcher(**kw)
    pm = PM.AutoMarcher(**kw)
    for quantize in (True, True, False):
        jout = jm(jnp.asarray(fine), coarse_occ=jnp.asarray(coarse))
        vj, fj = jm.unpack(jm.pack(jout, quantize=quantize))
        out = pm(t(fine), coarse_occ=t(coarse))
        vp, fp = pm.unpack(pm.pack(out, quantize=quantize))
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_allclose(vp, vj, rtol=0, atol=V_ATOL)
    assert pm._sizes() == jm._sizes() and pm._sizes()[1] < (1 << 16)
    with pytest.raises(ValueError):
        PM.AutoMarcher(codec="indexed", virtual=True)
    with pytest.raises(ValueError):
        PM.AutoMarcher(codec="soup")


def _same_lattice(out, ref):
    nv, nc = int(ref.n_verts), int(ref.n_cells)
    assert (int(out.n_verts), int(out.n_cells), int(out.n_verts_total),
            int(out.n_cells_total)) == (nv, nc, int(ref.n_verts_total),
                                        int(ref.n_cells_total))
    np.testing.assert_array_equal(out.vert_eid[:nv].numpy(),
                                  np.asarray(ref.vert_eid)[:nv])
    np.testing.assert_allclose(out.vert_s[:nv].numpy(),
                               np.asarray(ref.vert_s)[:nv], rtol=0,
                               atol=V_ATOL)
    np.testing.assert_array_equal(out.cell_id[:nc].numpy(),
                                  np.asarray(ref.cell_id)[:nc])
    np.testing.assert_array_equal(out.cell_bits[:nc].numpy(),
                                  np.asarray(ref.cell_bits)[:nc])


def test_marching_lattice_virtual_parity():
    """The virtual final level equals the JAX package's and the
    materialized path's (the upsample sliced by one with the coarse
    candidates) on the same grid."""
    coarse, fine = _grids()
    kw = dict(max_cells=1 << 15, max_verts=1 << 16)
    ref = JM.marching_lattice_virtual(jnp.asarray(coarse), **kw)
    out = PM.marching_lattice_virtual(t(coarse), **kw)
    assert out.vert_eid.dtype == torch.int64
    assert out.grid_shape == fine[1:, 1:, 1:].shape
    _same_lattice(out, ref)
    mat = JM.marching_lattice(jnp.asarray(fine[1:, 1:, 1:]),
                              coarse_occ=jnp.asarray(coarse), **kw)
    _same_lattice(out, mat)


def test_virtual_engine_and_marcher():
    """ReconEngine(virtual_final=True) returns the coarse grid with its
    final resolution, and AutoMarcher(virtual=True) on it decodes to the
    JAX package's virtual mesh and to the materialized path's mesh."""
    from icon_tpu.recon.engine import ReconEngine as JEngine
    from icon_tpu.utils.synthetic import clothed_human_occ as jocc
    from icon_tpu_torch.recon.engine import ReconEngine
    from icon_tpu_torch.utils.synthetic import clothed_human_occ
    res = (17, 33, 65)
    occ_v, st_v = ReconEngine(res, virtual_final=True, device="cpu")(
        lambda p: clothed_human_occ(p)[..., None])
    occ_m, st_m = ReconEngine(res, device="cpu")(
        lambda p: clothed_human_occ(p)[..., None])
    jocc_v, jst = JEngine(res, virtual_final=True)(
        lambda p: jocc(p)[..., None])
    assert occ_v.shape == (33, 33, 33) and st_v["final_res"] == 65
    assert jst["final_res"] == 65 and occ_m.shape == (65, 65, 65)
    np.testing.assert_allclose(occ_v.numpy(), np.asarray(jocc_v), rtol=0,
                               atol=1e-6)
    kw = dict(max_cells=1 << 15, max_tris=1 << 16)
    pm = PM.AutoMarcher(codec="lattice", virtual=True, **kw)
    jm = JM.AutoMarcher(codec="lattice", virtual=True, **kw)
    vv, fv = pm.unpack(pm.pack(pm(occ_v)))
    vj, fj = jm.unpack(jm.pack(jm(jnp.asarray(occ_v.numpy()))))
    np.testing.assert_array_equal(fv, fj)
    np.testing.assert_allclose(vv, vj, rtol=0, atol=1e-5)
    mm = PM.AutoMarcher(codec="lattice", slice_one=True, **kw)
    vm, fm = mm.unpack(mm.pack(mm(occ_m, coarse_occ=st_m["coarse_occ"])))
    assert len(fm) > 1000
    np.testing.assert_array_equal(fv, fm)
    np.testing.assert_allclose(vv, vm, rtol=0, atol=1e-5)
