"""Port parity, lattice marching: icon_tpu_torch.recon.marching against
icon_tpu.recon.marching on the same grids. Headers, cell ids, corner bits
and edge ids must be identical, fractions agree to 1e-6, and the decoded
meshes (wire v1 and v2) and extract_mesh must be identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu.recon import export as JE
from icon_tpu.recon import marching as JM
from icon_tpu_torch.kernels import lattice as PL
from icon_tpu_torch.recon import export as PE
from icon_tpu_torch.recon import lattice_host as PH
from icon_tpu_torch.recon import marching as PM


def _grids(n=33):
    """A lumpy ellipsoid at n^3 and its engine-style 2x upsample, sliced by
    one, for the coarse-candidate path."""
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2)
    r = r + 0.08 * np.sin(7 * x) * np.sin(5 * y)
    coarse = (1.0 / (1.0 + np.exp((r - 0.8) * 12))).astype(np.float32)
    from icon_tpu.ops.resize import resize3d_trilinear_align_corners
    fine = np.asarray(resize3d_trilinear_align_corners(
        jnp.asarray(coarse)[None, ..., None], (2 * n - 1,) * 3))[0, ..., 0]
    return coarse, fine


def test_host_tables_identical():
    for a, b in zip(PH._host_tables(), JM._host_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PH._host_tables_flat(), JM._host_tables_flat()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PH._EDGE_SLOTS, JM._EDGE_SLOTS)


def _assert_same_lattice(out, ref):
    nv, nc = int(ref.n_verts), int(ref.n_cells)
    assert (int(out.n_verts), int(out.n_cells), int(out.n_verts_total),
            int(out.n_cells_total)) == (nv, nc, int(ref.n_verts_total),
                                        int(ref.n_cells_total))
    assert nv > 0 and nc > 0
    np.testing.assert_array_equal(out.vert_eid[:nv].numpy(),
                                  np.asarray(ref.vert_eid)[:nv])
    np.testing.assert_allclose(out.vert_s[:nv].numpy(),
                               np.asarray(ref.vert_s)[:nv], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.cell_id[:nc].numpy(),
                                  np.asarray(ref.cell_id)[:nc])
    np.testing.assert_array_equal(out.cell_bits[:nc].numpy(),
                                  np.asarray(ref.cell_bits)[:nc])


@pytest.mark.parametrize("coarse_path", [False, True])
def test_marching_lattice_parity(coarse_path):
    coarse, fine = _grids()
    occ = fine[1:, 1:, 1:]
    kw = dict(max_cells=1 << 15, max_verts=1 << 16)
    ref = JM.marching_lattice(jnp.asarray(occ),
                              coarse_occ=jnp.asarray(coarse)
                              if coarse_path else None, **kw)
    out = PM.marching_lattice(t(occ), coarse_occ=t(coarse)
                              if coarse_path else None, **kw)
    assert out.vert_eid.dtype == torch.int64
    _assert_same_lattice(out, ref)


@pytest.mark.parametrize("implicit", [False, True])
def test_pack_and_decode_parity(implicit):
    coarse, fine = _grids()
    occ = fine[1:, 1:, 1:]
    D, H, W = occ.shape
    kw = dict(max_cells=1 << 15, max_verts=1 << 16)
    ref = JM.marching_lattice(jnp.asarray(occ), coarse_occ=jnp.asarray(coarse),
                              **kw)
    out = PM.marching_lattice(t(occ), coarse_occ=t(coarse), **kw)
    jbuf, jnv, jnc = JM.pack_lattice(ref, implicit_eid=implicit)
    buf, nvb, ncb = PM.pack_lattice(out, implicit_eid=implicit)
    assert (nvb, ncb) == (jnv, jnc) and buf.dtype == torch.int32
    jb, b = np.asarray(jbuf), buf.numpy()
    assert len(b) == len(jb)
    np.testing.assert_array_equal(b[:4], jb[:4])            # header
    nv, nc = int(b[0]), int(b[1])
    off = 4
    if not implicit:
        np.testing.assert_array_equal(b[off:off + nv], jb[off:off + nv])
        off += nvb
    s = b[off:off + (nvb + 3) // 4].view(np.uint8)[:nv].astype(int)
    js = jb[off:off + (nvb + 3) // 4].view(np.uint8)[:nv].astype(int)
    assert np.abs(s - js).max() <= 1          # u8 rounding of s to 1e-6
    off += (nvb + 3) // 4
    np.testing.assert_array_equal(b[off:off + nc], jb[off:off + nc])
    off += ncb
    np.testing.assert_array_equal(
        b[off:off + (ncb + 3) // 4].view(np.uint8)[:nc],
        jb[off:off + (ncb + 3) // 4].view(np.uint8)[:nc])
    v1, f1 = PH.decode_lattice((buf, nvb, ncb), H, W)
    v0, f0 = JM.decode_lattice((jbuf, jnv, jnc), H, W)
    assert len(f1) > 1000
    np.testing.assert_array_equal(f1, f0)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=1e-5)


def test_automarcher_and_extract_mesh_parity():
    """The serving marcher over three frames (autotuned buffers, packed
    sizes from measured counts) and extract_mesh both give the JAX
    package's meshes."""
    _, fine = _grids()
    jm = JE.make_marcher(max_cells=1 << 15, max_tris=1 << 16)
    pm = PE.make_marcher(max_cells=1 << 15, max_tris=1 << 16)
    for _ in range(3):
        vj, fj = JE.extract_mesh(jnp.asarray(fine), marcher=jm)
        vp, fp = PE.extract_mesh(t(fine), marcher=pm)
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-5)
    assert pm._counts_host is not None and pm._sizes()[0] < (1 << 15)
    # one-shot export (no marcher): a fresh lattice marcher, same mesh
    vo, fo = PE.extract_mesh(t(fine), max_cells=1 << 15, max_tris=1 << 16)
    np.testing.assert_array_equal(fo, fj)
    rad = np.linalg.norm(vo, axis=1)
    assert 0.3 < rad.mean() < 0.8 and np.abs(vo).max() <= 1.0


def test_pack_overflow_repacks_at_full_size():
    _, fine = _grids()
    occ = fine[1:, 1:, 1:]
    out = PM.marching_lattice(t(occ), max_cells=1 << 15, max_verts=1 << 16)
    tiny = PM.pack_lattice(out, sizes=(64, 64), bucket=64, implicit_eid=True)
    v, f, overflow = PH.decode_lattice(tiny, 64, 64, return_overflow=True)
    assert overflow and len(f) == 0
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice")
    res = m(t(occ))
    token = (tiny, res, (64, 64))
    v2, f2 = m.unpack(token)
    vr, fr = PH.decode_lattice(PM.pack_lattice(res), 64, 64)
    np.testing.assert_array_equal(f2, fr)
    assert len(f2) > 1000


def test_edge_ids_are_int64_past_int32():
    """Edge ids plin*8+dir pass 2^31 on a 700^3 lattice; the port keeps them
    exact in int64 (the JAX package's int32 ids wrap there), and the int32
    wire v1 refuses such a grid."""
    D = H = W = 700
    cx = torch.tensor([698, 10])
    cy = torch.tensor([698, 11])
    cz = torch.tensor([698, 12])
    cvals = torch.tensor([[1.0, 0, 0, 0, 0, 0, 0, 0],
                          [0.0, 1, 1, 1, 1, 1, 1, 1]])
    cell_idx = (cz * (H - 1) + cy) * (W - 1) + cx
    n = torch.tensor(2)
    out = PL.lattice_emit(cvals, cx, cy, cz, cell_idx, n, n, (D, H, W),
                          0.5, 64)
    nv = int(out.n_verts)
    eids = out.vert_eid[:nv].tolist()
    assert nv == 14 and max(eids) > 2 ** 31 and min(eids) > 0
    assert eids == sorted(eids)
    lo = (698 * H + 698) * W + 698
    assert lo * 8 + 1 in eids                 # x edge from the lo corner
    with pytest.raises(ValueError, match="int32 wire"):
        PM.pack_lattice(out, implicit_eid=False)
    PM.pack_lattice(out, implicit_eid=True)   # v2 carries no edge ids
