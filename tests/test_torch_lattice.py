"""The lattice kernels' plain twins (``icon_tpu_torch/kernels/lattice.py``)
against the JAX package on the same numpy inputs: the clothed-human field
of ``utils/synthetic.py`` at 65^3 and 129^3 with its coarse grid, and a
random field.

- ``lattice_cells_plain`` against JAX ``_active_cells`` (coarse and not):
  the live cells' coordinates, ids and the counts equal, their corner
  values the grid's own, rows past the count zero;
- ``lattice_emit_plain`` against JAX ``_lattice_emit`` on shared inputs:
  edge ids, corner bytes and counts equal, fractions bit-equal (their u8
  quantization therefore equal too);
- ``lattice_decode_plain`` against JAX ``decode_lattice(pack_lattice(...))``
  on wire v1 and v2: vertices bit-identical, faces identical in order; on
  an overflowed frame against wire v1 at full size (wire v2 reports the
  overflow, and the serving path re-packs it so);
- a decode buffer that overflows its sizes, re-packed by the marcher;
- ``lattice_cells_plain`` against JAX ``_active_cells`` on the layouts that
  the kernel's wide tiles make delicate (``tests/lattice_layouts.py``);
- the decode kernel's O(1) rank lookup through the emit's tables
  (``rank_tables_plain`` / ``rank_lookup_plain``) against
  ``torch.searchsorted`` on every key of the JAX-derived lattices, an
  overflowed emit among them, and its faces through the per-corner-byte
  tables against ``lattice_decode_plain``;
- the emit kernel's cooperative phases emulated in numpy (each phase's
  block shares for 1, 7 and 132 x k blocks, block totals summed across
  blocks, in-block scans) against ``lattice_emit_plain`` and
  ``rank_tables_plain`` on the fields' cells and the layouts', with
  empty blocks, no live cell and ``max_verts`` below the total.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lattice_layouts import LAYOUTS, fine_of, mixed_in_first_tile
from torch_port_helpers import t

from icon_tpu.recon import marching as JM
from icon_tpu_torch.kernels import lattice as PL
from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
from icon_tpu_torch.recon import lattice_host as PH
from icon_tpu_torch.recon import marching as PM
from icon_tpu_torch.utils.synthetic import clothed_human_occ


def _human(n: int):
    """The clothed human's occupancy at n^3 over [-1, 1]^3 and its 2x
    align_corners upsample sliced by one (the engine's final level)."""
    g = torch.linspace(-1.0, 1.0, n)
    z, y, x = torch.meshgrid(g, g, g, indexing="ij")
    pts = torch.stack([x, y, z], -1).reshape(1, -1, 3)
    coarse = clothed_human_occ(pts, sharpness=40.0).reshape(n, n, n)
    fine = resize3d_trilinear_align_corners(coarse[None, None],
                                            (2 * n - 1,) * 3)[0, 0]
    return coarse.numpy(), fine[1:, 1:, 1:].contiguous().numpy()


def _random(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    coarse = rng.rand(n, n, n).astype(np.float32)
    fine = resize3d_trilinear_align_corners(
        torch.from_numpy(coarse)[None, None], (2 * n - 1,) * 3)[0, 0]
    return coarse, fine[1:, 1:, 1:].contiguous().numpy()


FIELDS = {"human65": lambda: _human(33), "human129": lambda: _human(65),
          "random": lambda: _random(17)}


@pytest.fixture(scope="module", params=sorted(FIELDS))
def field(request):
    return request.param, FIELDS[request.param]()


def _jax_cells(occ, coarse, max_cells, max_candidates=None):
    return JM._active_cells(jnp.asarray(occ), 0.5, max_cells,
                            None if coarse is None else jnp.asarray(coarse),
                            max_candidates)


@pytest.mark.parametrize("coarse_path", [True, False])
@pytest.mark.parametrize("max_cells", [1 << 16, 700])
def test_cells_equal_jax(field, coarse_path, max_cells):
    name, (coarse, occ) = field
    cg = coarse if coarse_path else None
    ref = _jax_cells(occ, cg, max_cells)
    got = PL.lattice_cells_plain(t(occ), 0.5, max_cells,
                                 None if cg is None else t(cg))
    n = int(ref[5])
    assert (int(got.n_cells), int(got.n_cells_total)) == (n, int(ref[6]))
    assert n > 0 and got.cx.dtype == torch.int64
    for a, b in zip((got.cx, got.cy, got.cz, got.cell_idx), ref[:4]):
        np.testing.assert_array_equal(a[:n].numpy(), np.asarray(b)[:n])
        assert not a[n:].any()
    cx, cy, cz = (a[:n].numpy() for a in (got.cx, got.cy, got.cz))
    want = np.stack([occ[cz + (c >> 2 & 1), cy + (c >> 1 & 1), cx + (c & 1)]
                     for c in range(8)], -1)
    np.testing.assert_array_equal(got.cvals[:n].numpy(), want)
    assert not got.cvals[n:].any()
    if max_cells == 700:
        assert int(got.n_cells_total) > 700


def test_cells_candidate_budget_overflow():
    """A candidate budget below the mixed coarse cells: the first budget's
    cells, and 8 more for each mixed coarse cell dropped."""
    coarse, occ = _human(33)
    ref = _jax_cells(occ, coarse, 1 << 16, max_candidates=8 * 300)
    got = PL.lattice_cells_plain(t(occ), 0.5, 1 << 16, t(coarse),
                                 max_candidates=8 * 300)
    n = int(ref[5])
    assert (int(got.n_cells), int(got.n_cells_total)) == (n, int(ref[6]))
    assert int(got.n_cells_total) > n
    np.testing.assert_array_equal(got.cell_idx[:n].numpy(),
                                  np.asarray(ref[3])[:n])


def test_cells_take_strided_grids():
    """The engine's sliced view (not contiguous) gives the cells of its
    contiguous copy."""
    coarse, occ = _human(33)
    full = torch.zeros((occ.shape[0] + 1,) * 3)
    full[1:, 1:, 1:] = t(occ)
    view = full[1:, 1:, 1:]
    assert not view.is_contiguous()
    a = PL.lattice_cells(view, 0.5, 1 << 15, t(coarse))
    b = PL.lattice_cells(t(occ), 0.5, 1 << 15, t(coarse))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _shared_emit_inputs(occ, coarse, max_cells):
    cx, cy, cz, cell_idx, alive, n_cells, n_total = _jax_cells(
        occ, coarse, max_cells)
    cx, cy, cz, cell_idx = (np.asarray(a) for a in (cx, cy, cz, cell_idx))
    D, H, W = occ.shape
    cvals = np.stack([occ[np.minimum(cz + (c >> 2 & 1), D - 1),
                          np.minimum(cy + (c >> 1 & 1), H - 1),
                          np.minimum(cx + (c & 1), W - 1)]
                      for c in range(8)], -1).astype(np.float32)
    return cvals, cx, cy, cz, cell_idx, np.asarray(alive), int(n_cells), \
        int(n_total)


@pytest.mark.parametrize("max_verts", [1 << 17, 900])
def test_emit_equals_jax(field, max_verts):
    name, (coarse, occ) = field
    cvals, cx, cy, cz, cid, alive, n, n_total = _shared_emit_inputs(
        occ, coarse, 1 << 16)
    ref = JM._lattice_emit(jnp.asarray(cvals), jnp.asarray(cx),
                           jnp.asarray(cy), jnp.asarray(cz),
                           jnp.asarray(cid), jnp.asarray(alive),
                           jnp.int32(n), jnp.int32(n_total), occ.shape, 0.5,
                           max_verts)
    i64 = (lambda a: torch.from_numpy(a.astype(np.int64)))
    got = PL.lattice_emit_plain(torch.from_numpy(cvals), i64(cx), i64(cy),
                                i64(cz), i64(cid), torch.tensor(n),
                                torch.tensor(n_total), occ.shape, 0.5,
                                max_verts)
    nv = int(ref.n_verts)
    assert [int(x) for x in (got.n_verts, got.n_cells, got.n_verts_total,
                             got.n_cells_total)] == [
        nv, int(ref.n_cells), int(ref.n_verts_total), int(ref.n_cells_total)]
    assert nv > 0
    np.testing.assert_array_equal(got.vert_eid[:nv].numpy(),
                                  np.asarray(ref.vert_eid)[:nv])
    np.testing.assert_array_equal(got.vert_s[:nv].numpy().view(np.int32),
                                  np.asarray(ref.vert_s)[:nv].view(np.int32))
    np.testing.assert_array_equal(got.cell_bits[:n].numpy(),
                                  np.asarray(ref.cell_bits)[:n])
    assert (got.vert_eid[nv:] == PL.INT64_MAX).all()
    assert not got.vert_s[nv:].any() and not got.cell_bits[n:].any()
    if max_verts == 900:
        assert int(got.n_verts_total) > 900


def _port_lattice(ref, shape) -> PL.LatticeOut:
    """The JAX package's LatticeOut with the port's dtypes (int64 ids, dead
    ids INT64_MAX)."""
    nv = int(ref.n_verts)
    eid = np.asarray(ref.vert_eid).astype(np.int64)
    eid[nv:] = PL.INT64_MAX
    return PL.LatticeOut(
        torch.from_numpy(eid), torch.from_numpy(np.array(ref.vert_s)),
        torch.from_numpy(np.asarray(ref.cell_id).astype(np.int64)),
        torch.from_numpy(np.asarray(ref.cell_bits).astype(np.int32)),
        torch.tensor(nv), torch.tensor(int(ref.n_cells)),
        torch.tensor(int(ref.n_verts_total)),
        torch.tensor(int(ref.n_cells_total)), tuple(shape))


def _decoded(out):
    return PL.unpack_decoded(PL.lattice_decode_plain(
        out, *PL.decode_sizes(out)), *PL.decode_sizes(out))


def _same_mesh(got, want):
    verts, faces = got
    assert verts.dtype == np.float32 and faces.dtype == np.int64
    np.testing.assert_array_equal(verts.view(np.int32),
                                  np.asarray(want[0], np.float32).view(
                                      np.int32))
    np.testing.assert_array_equal(faces, want[1])


@pytest.mark.parametrize("implicit", [False, True])
def test_decode_equals_jax_decode(field, implicit):
    name, (coarse, occ) = field
    D, H, W = occ.shape
    kw = dict(max_cells=1 << 16, max_verts=1 << 17)
    ref = JM.marching_lattice(jnp.asarray(occ), coarse_occ=jnp.asarray(coarse),
                              **kw)
    want = JM.decode_lattice(JM.pack_lattice(ref, implicit_eid=implicit),
                             H, W)
    assert len(want[1]) > 100
    verts, faces, overflow = _decoded(_port_lattice(ref, occ.shape))
    assert not overflow
    _same_mesh((verts, faces), want)
    # the port's own march and decode give the same mesh
    out = PM.marching_lattice(t(occ), coarse_occ=t(coarse), **kw)
    verts, faces, overflow = _decoded(out)
    assert not overflow
    _same_mesh((verts, faces), want)


@pytest.mark.parametrize("cut", ["cells", "verts"])
def test_decode_of_an_overflowed_frame(cut):
    """A march that outgrew its own buffers: the decode equals wire v1 at
    full size (faces whose edges were dropped go), and wire v2 reports the
    overflow, which the serving path re-packs as v1."""
    coarse, occ = _human(33)
    D, H, W = occ.shape
    kw = dict(max_cells=600, max_verts=1 << 17) if cut == "cells" else \
        dict(max_cells=1 << 16, max_verts=2000)
    ref = JM.marching_lattice(jnp.asarray(occ), coarse_occ=jnp.asarray(coarse),
                              **kw)
    assert int(ref.n_cells_total) > int(ref.n_cells) or \
        int(ref.n_verts_total) > int(ref.n_verts)
    want = JM.decode_lattice(JM.pack_lattice(ref), H, W)
    _, _, v2_over = JM.decode_lattice(JM.pack_lattice(ref, implicit_eid=True),
                                      H, W, return_overflow=True)
    assert v2_over and len(want[1]) > 100
    verts, faces, overflow = _decoded(_port_lattice(ref, occ.shape))
    assert not overflow
    _same_mesh((verts, faces), want)
    out = PM.marching_lattice(t(occ), coarse_occ=t(coarse), **kw)
    _same_mesh(_decoded(out)[:2], want)


def test_small_decode_buffer_overflows_and_repacks():
    """A decode buffer below the mesh's counts reports the overflow; the
    marcher re-packs it at the header's counts, giving the whole mesh."""
    coarse, occ = _human(33)
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice")
    out = m(t(occ), coarse_occ=t(coarse))
    full = _decoded(out)
    small = PL.lattice_decode_plain(out, 64, 64)
    assert int(small[0]) == len(full[0]) and int(small[1]) == len(full[1])
    v, f, overflow = PL.unpack_decoded(small, 64, 64)
    assert overflow and len(v) == 64 and len(f) == 64
    np.testing.assert_array_equal(f, full[1][:64])
    token = ((small, 64, 64), out, PM._DECODED)
    verts, faces = m.unpack(token)
    _same_mesh((verts, faces), full[:2])
    assert len(faces) > 1000


def test_empty_lattice_decodes_to_nothing():
    occ = torch.full((9, 10, 11), 0.25)
    out = PM.marching_lattice(occ, max_cells=64, max_verts=64)
    assert int(out.n_verts) == 0 and int(out.n_cells) == 0
    verts, faces, overflow = _decoded(out)
    assert verts.shape == (0, 3) and faces.shape == (0, 3) and not overflow


def test_cpu_tensors_take_the_plain_twins():
    """On CPU tensors the wrappers are the plain twins and count no
    launch; the CPU marcher still packs the wire for the host decoder."""
    coarse, occ = _human(33)
    before = (PL.launches_cells, PL.launches_emit, PL.launches_decode)
    c = PL.lattice_cells(t(occ), 0.5, 1 << 15, t(coarse))
    p = PL.lattice_cells_plain(t(occ), 0.5, 1 << 15, t(coarse))
    assert all(torch.equal(a, b) for a, b in zip(c, p))
    out = PL.lattice_emit(c.cvals, c.cx, c.cy, c.cz, c.cell_idx, c.n_cells,
                          c.n_cells_total, occ.shape, 0.5, 1 << 16)
    sizes = PL.decode_sizes(out)
    assert torch.equal(PL.lattice_decode(out, *sizes),
                       PL.lattice_decode_plain(out, *sizes))
    assert (PL.launches_cells, PL.launches_emit, PL.launches_decode) == before
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice")
    token = m.pack(m(t(occ), coarse_occ=t(coarse)))
    assert token[2] == m._dims            # the wire, for the host decoder
    decodes = PH.host_decodes
    verts, faces = m.unpack(token)
    assert PH.host_decodes == decodes + 1
    _same_mesh((verts, faces), _decoded(out)[:2])


@pytest.mark.parametrize("max_cells", [1 << 14, 40])
@pytest.mark.parametrize("coarse_path", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cells_layouts_equal_jax(layout, coarse_path, max_cells):
    """The tiles' delicate layouts: the budget's last mixed coarse cell at
    the first tile's edge (and one either side), ragged sides, mixed cells
    on every face, a single mixed cell at either corner, an empty grid."""
    coarse, max_candidates = LAYOUTS[layout]()
    occ = fine_of(coarse)
    cg = coarse if coarse_path else None
    ref = _jax_cells(occ, cg, max_cells, max_candidates)
    got = PL.lattice_cells_plain(t(occ), 0.5, max_cells,
                                 None if cg is None else t(cg),
                                 max_candidates)
    n = int(ref[5])
    assert (int(got.n_cells), int(got.n_cells_total)) == (n, int(ref[6]))
    for a, b in zip((got.cx, got.cy, got.cz, got.cell_idx), ref[:4]):
        np.testing.assert_array_equal(a[:n].numpy(), np.asarray(b)[:n])
        assert not a[n:].any()
    assert not got.cvals[n:].any()
    if layout == "empty":
        assert int(got.n_cells_total) == 0
    elif layout.startswith("single"):
        assert int(PL._mixed_cells(t(coarse), 0.5).sum()) == 1 and n > 0
    elif layout.startswith("tile_edge") and coarse_path and \
            max_cells > 40:
        # the budget ends at, before or after the first tile's last
        # mixed cell, and cuts the second tile's
        assert mixed_in_first_tile(coarse) > 0
        assert int(got.n_cells_total) > n


def _all_keys(out: PL.LatticeOut) -> torch.Tensor:
    """Every edge id the decode looks up: each live cell's 19 slots."""
    D, H, W = out.grid_shape
    nc = int(out.n_cells)
    cid = out.cell_id[:nc]
    cw, ch = W - 1, H - 1
    x, y, z = cid % cw, (cid // cw) % ch, cid // (cw * ch)
    slots = torch.from_numpy(PL._EDGE_SLOTS.astype(np.int64))
    lo = slots[:, 0]
    lin = ((z[:, None] + ((lo >> 2) & 1)) * H +
           (y[:, None] + ((lo >> 1) & 1))) * W + (x[:, None] + (lo & 1))
    return (lin * 8 + slots[:, 2]).reshape(-1)


def _searchsorted_rank(out: PL.LatticeOut, keys: torch.Tensor):
    nv = int(out.n_verts)
    ids = out.vert_eid[:nv]
    r = torch.searchsorted(ids, keys)
    found = (r < nv) & (ids[torch.clamp(r, max=max(nv - 1, 0))] == keys)
    return torch.where(found, r, torch.full_like(r, -1))


def _jax_lattice(field_arrays, **kw):
    coarse, occ = field_arrays
    ref = JM.marching_lattice(jnp.asarray(occ),
                              coarse_occ=jnp.asarray(coarse), **kw)
    return _port_lattice(ref, occ.shape)


@pytest.mark.parametrize("max_verts", [1 << 17, 2000])
def test_rank_lookup_equals_searchsorted(field, max_verts):
    """The decode's rank of each key through the emit's tables equals
    torch.searchsorted's among the kept ids (-1 where none), on every slot
    key of every live cell, every id, and keys past the grid. With 2000
    vertices the emit overflows: dropped ids share bitmap words with kept
    ones and rank -1."""
    name, arrays = field
    out = _jax_lattice(arrays, max_cells=1 << 16, max_verts=max_verts)
    nv = int(out.n_verts)
    tables = PL.rank_tables_plain(out.vert_eid, out.n_verts,
                                  out.grid_shape)
    n_ids = tables[0].shape[0] * 1024
    keys = torch.cat([_all_keys(out), out.vert_eid[:nv],
                      torch.tensor([0, n_ids - 1, n_ids, n_ids + 99, -1])])
    got = PL.rank_lookup_plain(tables, keys)
    assert torch.equal(got, _searchsorted_rank(out, keys))
    assert torch.equal(PL.rank_lookup_plain(tables, out.vert_eid[:nv]),
                       torch.arange(nv))
    if max_verts == 2000:
        full = _jax_lattice(arrays, max_cells=1 << 16, max_verts=1 << 17)
        all_ids = full.vert_eid[:int(full.n_verts)]
        dropped = all_ids[~torch.isin(all_ids, out.vert_eid[:nv])]
        shared = torch.isin(dropped >> 5, out.vert_eid[:nv] >> 5)
        assert int(out.n_verts_total) > nv and shared.any()
        assert (PL.rank_lookup_plain(tables, dropped) == -1).all()


def _table_decode_faces(out: PL.LatticeOut) -> torch.Tensor:
    """The decode kernel's faces in PyTorch: each live cell's used slots
    ranked through the rank tables, its faces from the per-corner-byte
    tables, a face with a missing or repeated rank dropped."""
    used, nf, faces = PL._cell_face_tables()
    nc = int(out.n_cells)
    keys = _all_keys(out).reshape(nc, 19)
    tables = PL.rank_tables_plain(out.vert_eid, out.n_verts,
                                  out.grid_shape)
    bits = (out.cell_bits[:nc].to(torch.int64) & 0xFF).numpy()
    slot_used = (used[bits][:, None] >> np.arange(19)) & 1     # [nc, 19]
    rank = PL.rank_lookup_plain(tables, keys)
    rank = torch.where(torch.from_numpy(slot_used.astype(bool)), rank,
                       torch.full_like(rank, -7))   # never read
    tri = torch.from_numpy(faces[bits].astype(np.int64)).reshape(nc, 12, 3)
    r = torch.gather(rank, 1, tri.reshape(nc, 36)).reshape(nc, 12, 3)
    live = torch.arange(12)[None] < torch.from_numpy(nf[bits].astype(
        np.int64))[:, None]
    assert (r[live] != -7).all()
    ok = live & (r >= 0).all(-1) & (r[..., 0] != r[..., 1]) & \
        (r[..., 1] != r[..., 2]) & (r[..., 0] != r[..., 2])
    return r[ok].to(torch.int32)


@pytest.mark.parametrize("cut", [None, "verts"])
def test_table_decode_equals_plain(field, cut):
    """The decode kernel's algorithm (used slots, O(1) ranks, the
    per-corner-byte face tables) gives the plain twin's faces in order,
    on an overflowed emit too."""
    name, arrays = field
    kw = dict(max_cells=1 << 16, max_verts=1 << 17 if cut is None else 2000)
    out = _jax_lattice(arrays, **kw)
    nvb, nfb = PL.decode_sizes(out)
    buf = PL.lattice_decode_plain(out, nvb, nfb)
    nf = int(buf[1])
    fo = PL.HEADER + 3 * nvb
    got = _table_decode_faces(out)
    assert nf > 100 and got.shape[0] == nf
    assert torch.equal(got.reshape(-1), buf[fo:fo + 3 * nf])


def test_cells_tiles():
    """Tiles of whole rows, at most CELLS_TILE_CELLS cells as 32-cell
    words: 512 over phase 19's 129^3 coarse grid, 4,096 over 257^3."""
    assert PL.cells_tile_rows(128) == 32 and PL.cells_tile_rows(129) == 25
    assert PL.cells_tiles((129, 129, 129)) == 512
    assert PL.cells_tiles((257, 257, 257)) == 4096
    assert PL.cells_tile_rows(4096) == 1 and PL.cells_tile_rows(1) == 128


def _share(n: int, grid: int, b: int):
    """``csrc/lattice.cu:block_share``: block ``b``'s contiguous share
    [lo, hi) of ``n`` items among ``grid`` blocks, in multiples of 32."""
    per = -(-n // grid)
    per = -(-per // 32) * 32
    lo = min(b * per, n)
    return lo, min(lo + per, n)


def _exclusive(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x) - x


# csrc/lattice.cu's kSumRun: summary words a thread takes at once
SUM_RUN = 8


def _emit_phases(cvals, cx, cy, cz, n_cells, fine_shape, iso, max_verts,
                 grid, threads=PL.EMIT_THREADS):
    """``lattice_emit``'s cooperative launch (``csrc/lattice.cu:
    emit_kernel`` with ``rank_phases``) in numpy for ``grid`` blocks of
    ``threads``: each phase's block shares, the block totals summed before
    each block after a barrier, the in-block scans tile by tile (runs of
    ``SUM_RUN`` summary words a thread), the summary marks, the word rows
    zeroed over the touched words' shares, the ORed bits, the rows' scan,
    the placement. Returns (vert_eid, vert_s, cell_bits, counts [kept,
    total, min(n_cells, nc)], [summary, sum_rank, word_rank], the shares
    of each phase); rows no phase writes hold -1."""
    D, H, W = fine_shape
    nc = cx.shape[0]
    slots = PL._EDGE_SLOTS.astype(np.int64)               # (lo, hi, dir)
    off = PL._CORNER_OFF[slots[:, 0]].astype(np.int64)    # (x, y, z)
    key = ((off[:, 2] * H + off[:, 1]) * W + off[:, 0]) * 8 + slots[:, 2]
    n_sum = PL._n_sum(fine_shape)
    live = min(max(n_cells, 0), nc)
    iso = np.float32(iso)
    inside = cvals > iso
    own = (((off[None, :, 0] == 0) | (cx[:, None] == W - 2)) &
           ((off[None, :, 1] == 0) | (cy[:, None] == H - 2)) &
           ((off[None, :, 2] == 0) | (cz[:, None] == D - 2)))
    mask = (inside[:, slots[:, 0]] != inside[:, slots[:, 1]]) & own
    popc = np.bitwise_count
    shares = {"cells": [_share(live, grid, b) for b in range(grid)],
              "summary": [_share(n_sum, grid, b) for b in range(grid)]}

    # 1. block totals; after the barrier each block's slots in order
    cell_bits = np.full(nc, -1, np.int64)
    totals = np.array([mask[lo:hi].sum() for lo, hi in shares["cells"]])
    total = int(totals.sum())
    kept = min(total, max_verts)
    keid = np.full(max_verts, -1, np.int64)
    ks = np.full(max_verts, np.nan, np.float32)
    summary = np.zeros(n_sum, np.int64)
    for (lo, hi), at in zip(shares["cells"], _exclusive(totals)):
        cell_bits[lo:hi] = (inside[lo:hi] * (1 << np.arange(8))).sum(-1)
        for t0 in range(lo, hi, threads):
            m = mask[t0:min(t0 + threads, hi)]
            cnt = m.sum(1)
            pos = (at + _exclusive(cnt))[:, None] + np.cumsum(m, 1) - 1
            rows, s = np.nonzero(m & (pos < max_verts))
            c = t0 + rows
            v = cvals[c]
            vlo = v[np.arange(len(c)), slots[s, 0]]
            vhi = v[np.arange(len(c)), slots[s, 1]]
            den = vhi - vlo
            f = np.clip((iso - vlo) / np.where(den == 0, np.float32(1), den),
                        np.float32(0), np.float32(1))
            e = ((cz[c] * H + cy[c]) * W + cx[c]) * 8 + key[s]
            keid[pos[rows, s]] = e
            ks[pos[rows, s]] = f
            np.bitwise_or.at(summary, e >> 10, 1 << ((e >> 5) & 31))
            at += int(cnt.sum())

    # 2. the summary words' totals; sum_rank and the touched rows zeroed
    t_words = np.array([popc(summary[lo:hi]).sum()
                        for lo, hi in shares["summary"]], np.int64)
    touched = int(t_words.sum())
    shares["words"] = [_share(touched, grid, b) for b in range(grid)]
    sum_rank = np.full((n_sum, 2), -1, np.int64)
    for (lo, hi), at in zip(shares["summary"], _exclusive(t_words)):
        for t0 in range(lo, hi, threads * SUM_RUN):
            t1 = min(t0 + threads * SUM_RUN, hi)
            runs = np.zeros(-(-(t1 - t0) // SUM_RUN) * SUM_RUN, np.int64)
            runs[:t1 - t0] = summary[t0:t1]
            runs = runs.reshape(-1, SUM_RUN)            # a thread's words
            n = popc(runs)
            k = (at + _exclusive(n.sum(1)))[:, None] + \
                np.cumsum(n, 1) - n
            hit = np.nonzero(runs.reshape(-1))[0]
            sum_rank[t0 + hit] = np.stack([k.reshape(-1)[hit],
                                           runs.reshape(-1)[hit]], -1)
            at += int(n.sum())
    word_rank = np.full((min(max_verts, 32 * n_sum), 2), -1, np.int64)
    for lo, hi in shares["words"]:
        word_rank[lo:hi] = 0
    # each kept id's bit in its word's row; the rows past the live cells
    e = keid[:kept]
    sr = sum_rank[e >> 10]
    k = sr[:, 0] + popc(sr[:, 1] & ((1 << ((e >> 5) & 31)) - 1))
    np.bitwise_or.at(word_rank[:, 1], k, 1 << (e & 31))
    cell_bits[live:] = 0
    # the rows' totals, then each row's ids before it
    t_rows = np.array([popc(word_rank[lo:hi, 1]).sum()
                       for lo, hi in shares["words"]], np.int64)
    for (lo, hi), at in zip(shares["words"], _exclusive(t_rows)):
        for t0 in range(lo, hi, threads):
            n = popc(word_rank[t0:min(t0 + threads, hi), 1])
            word_rank[t0:min(t0 + threads, hi), 0] = at + _exclusive(n)
            at += int(n.sum())

    # 3. each kept id at its rank
    wr = word_rank[k]
    r = wr[:, 0] + popc(wr[:, 1] & ((1 << (e & 31)) - 1))
    vert_eid = np.full(max_verts, PL.INT64_MAX, np.int64)
    vert_s = np.zeros(max_verts, np.float32)
    vert_eid[r] = e
    vert_s[r] = ks[:kept]
    counts = [kept, total, min(n_cells, nc)]
    return vert_eid, vert_s, cell_bits, counts, \
        [summary, sum_rank, word_rank], shares


def _phases_equal_plain(cells: PL.Cells, shape, max_verts: int, grid: int):
    """The emulated cooperative emit for ``grid`` blocks against
    ``lattice_emit_plain`` and ``rank_tables_plain`` on ``cells``; returns
    the plain lattice."""
    args = (cells.cx, cells.cy, cells.cz, cells.cell_idx, cells.n_cells,
            cells.n_cells_total, tuple(shape), 0.5, max_verts)
    ref = PL.lattice_emit_plain(cells.cvals, *args)
    vert_eid, vert_s, cell_bits, counts, tables, shares = _emit_phases(
        cells.cvals.numpy(), cells.cx.numpy(), cells.cy.numpy(),
        cells.cz.numpy(), int(cells.n_cells), tuple(shape), 0.5, max_verts,
        grid)
    np.testing.assert_array_equal(vert_eid, ref.vert_eid.numpy())
    np.testing.assert_array_equal(vert_s.view(np.int32),
                                  ref.vert_s.numpy().view(np.int32))
    np.testing.assert_array_equal(cell_bits, ref.cell_bits.numpy())
    assert counts == [int(ref.n_verts), int(ref.n_verts_total),
                      int(ref.n_cells)]
    summary, sum_rank, word_rank = (t.numpy() for t in PL.rank_tables_plain(
        ref.vert_eid, ref.n_verts, ref.grid_shape))
    touched = summary != 0
    np.testing.assert_array_equal(tables[0], summary)
    # sum_rank rows for the touched summary words only, as the decode
    # reads them; word_rank's rows past the touched words untouched
    np.testing.assert_array_equal(tables[1][touched], sum_rank[touched])
    assert (tables[1][~touched] == -1).all()
    n = word_rank.shape[0]
    np.testing.assert_array_equal(tables[2][:n], word_rank)
    assert (tables[2][n:] == -1).all()
    # each phase's shares tile its items in block order
    for name, n_items in (("cells", int(min(max(int(cells.n_cells), 0),
                                            cells.cx.shape[0]))),
                          ("summary", summary.shape[0]), ("words", n)):
        ends = [b for ab in shares[name] for b in ab]
        assert ends[0] == 0 and ends[-1] == n_items and \
            all(a <= b for a, b in zip(ends, ends[1:]))
    return ref


# 1 and 7 blocks, and 132 SMs times 1, 2 and 8 blocks (most of them
# with an empty share at these sizes)
PHASE_GRIDS = [1, 7, 132, 264, 1056]


@pytest.mark.parametrize("max_verts", [1 << 17, 2000, 777])
@pytest.mark.parametrize("grid", PHASE_GRIDS)
def test_emit_phases_equal_plain(field, grid, max_verts):
    """The cooperative emit's phase structure, emulated for ``grid`` blocks
    on the JAX-tested fields' cells: the plain twin's outputs and rank
    tables, with all vertices kept, and with ``max_verts`` below the total
    (2000, and 777, no multiple of a block)."""
    name, (coarse, occ) = field
    cells = PL.lattice_cells_plain(t(occ), 0.5, 1 << 16, t(coarse))
    ref = _phases_equal_plain(cells, occ.shape, max_verts, grid)
    assert (int(ref.n_verts_total) > max_verts) == (max_verts < 1 << 17)


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_emit_phases_on_layouts(layout, grid):
    """The emulated phases on the cells of the tiles' delicate layouts: a
    single live cell, mixed cells on every face, a grid with no live cell;
    ``max_verts`` 300, below the total of the larger ones."""
    coarse, max_candidates = LAYOUTS[layout]()
    occ = fine_of(coarse)
    cells = PL.lattice_cells_plain(t(occ), 0.5, 1 << 14, t(coarse),
                                   max_candidates)
    ref = _phases_equal_plain(cells, occ.shape, 300, grid)
    if layout == "empty":
        assert int(cells.n_cells) == 0 and int(ref.n_verts_total) == 0
