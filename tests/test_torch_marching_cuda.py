"""The indexed marcher's CUDA kernels (``mt_emit``, ``mt_index``) against
their plain PyTorch twins, on the card.

The kernels round each vertex's arithmetic as the plain version does and
every slot of one lattice edge computes its point from the edge's inside
corner, so the counts and the faces are identical and the vertices agree
to 1e-6 grid units (in practice bit for bit).

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_marching_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import sys
import threading

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


# --- the single-pass emit and the surface-sized index, bit for bit ---------

def _plain(occ, cells, iso, max_tris, max_verts):
    cx, cy, cz, n_cells = cells
    e = km.mt_emit_plain(occ, cx, cy, cz, n_cells, iso, max_tris)
    i = km.mt_index_plain(*e[:5], max_verts, tuple(occ.shape))
    return e, i


def _active(occ, max_cells=1 << 16, iso=0.5):
    cx, cy, cz, _, _, n_cells, _ = PM._active_cells(occ, iso, max_cells,
                                                    None)
    return cx, cy, cz, n_cells


def _held(got_e, got_i, occ, cells, iso, max_tris, max_verts):
    """The kernels' (tvx, tvy, tvz, teid, n_tris, n_total) and (vx, vy,
    vz, faces, n_unique) identical to the plain versions' where the
    contract defines them; returns (n_tris, n_unique)."""
    pe, pi = _plain(occ, cells, iso, max_tris, max_verts)
    pe, pi = [x.cpu() for x in pe], [x.cpu() for x in pi]
    got_e = [x.cpu() for x in got_e]
    got_i = [x.cpu() for x in got_i]
    nt, nu = int(pe[4]), int(pi[4])
    assert [int(got_e[4]), int(got_e[5]), int(got_i[4])] == \
        [nt, int(pe[5]), nu]
    assert torch.equal(got_e[3], pe[3])           # INT64_MAX past n_tris
    for k in range(3):
        assert torch.equal(got_e[k][:nt], pe[k][:nt])
        assert torch.equal(got_i[k][:min(nu, max_verts)],
                           pi[k][:min(nu, max_verts)])
    assert torch.equal(got_i[3], pi[3])           # 0 past n_tris
    return nt, nu


def _wrappers(occ, cells, iso, max_tris, max_verts):
    e = km.mt_emit(occ, *cells, iso, max_tris)
    i = km.mt_index(*e[:5], max_verts, tuple(occ.shape))
    torch.cuda.synchronize()
    return e, i


def _on_buffers(eb, ib, occ, cells, iso, max_tris, max_verts):
    km._emit_launch(occ, *cells, iso, max_tris, eb)
    n_tris = torch.clamp(eb.n_total, max=max_tris)
    km._index_launch(eb.tv[0], eb.tv[1], eb.tv[2], eb.teid, n_tris,
                     max_verts, ib)
    torch.cuda.synchronize()
    return ((eb.tv[0], eb.tv[1], eb.tv[2], eb.teid, n_tris, eb.n_total),
            (ib.verts[0], ib.verts[1], ib.verts[2], ib.faces, ib.n_unique))


def _far_corner(shape):
    """A surface only near the grid's far corner: its edge ids reach the
    last word of the bitmap and of its summary."""
    D, H, W = shape
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32)
                            for n in shape), indexing="ij")
    d = (D - 1 - z) + (H - 1 - y) + (W - 1 - x)
    return torch.from_numpy(np.clip(2.2 - d, 0, 1).astype(np.float32) *
                            0.7 + 0.1)


@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_empty_mesh(cuda_device, fill):
    """An all-outside and an all-inside grid: no live cell, n_tris 0,
    every face 0 and every teid INT64_MAX."""
    occ = torch.full((17, 19, 23), fill)
    cells = _active(occ)
    assert int(cells[3]) == 0
    got = _wrappers(occ.to(cuda_device), [c.to(cuda_device) for c in cells],
                    0.5, 4096, 4096)
    assert _held(*got, occ, cells, 0.5, 4096, 4096) == (0, 0)


@pytest.mark.parametrize("where", ["inside", "edge"])
def test_max_tris_cut_in_a_tile_and_at_its_edge(cuda_device, where):
    """The cut falls 7 triangles into tile 20, or exactly where tile 20
    begins (the triangles of its first 20 tiles of cells)."""
    _, fine = _grids(33)
    occ = fine[1:, 1:, 1:].contiguous()
    cells = _active(occ)
    cx, cy, cz, n_cells = cells
    tile = km.EMIT_TILE_CELLS
    assert int(n_cells) > 21 * tile
    first = int(km.mt_emit_plain(occ, cx, cy, cz, torch.tensor(20 * tile),
                                 0.5, 1 << 16)[5])
    max_tris = first + (7 if where == "inside" else 0)
    got = _wrappers(occ.to(cuda_device), [c.to(cuda_device) for c in cells],
                    0.5, max_tris, 1 << 16)
    nt, _ = _held(*got, occ, cells, 0.5, max_tris, 1 << 16)
    assert nt == max_tris < int(got[0][5])


def test_max_verts_cut(cuda_device):
    _, fine = _grids(33)
    occ = fine[1:, 1:, 1:].contiguous()
    cells = _active(occ)
    got = _wrappers(occ.to(cuda_device), [c.to(cuda_device) for c in cells],
                    0.5, 1 << 16, 1000)
    _, nu = _held(*got, occ, cells, 0.5, 1 << 16, 1000)
    assert nu > 1000 and int(got[1][3].max()) >= 1000


@pytest.mark.parametrize("shape", [(17, 19, 23), (40, 57, 71), (64, 64, 64)])
def test_far_corner_ids_in_the_last_words(cuda_device, shape):
    """D != H != W (and a cube whose id space is a whole number of summary
    words): the largest edge id lies in the bitmap's last used word and
    the summary's last word."""
    occ = _far_corner(shape)
    cells = _active(occ)
    got = _wrappers(occ.to(cuda_device), [c.to(cuda_device) for c in cells],
                    0.5, 4096, 4096)
    nt, _ = _held(*got, occ, cells, 0.5, 4096, 4096)
    sz = km.index_sizes(4096, shape)
    top = int(got[0][3][:nt].max())
    assert nt > 0 and top >> 10 == sz["summary"] - 1
    # the id space's last word, or the one before where the last holds
    # only the last point's ids (an edge's id is its lower point's)
    last = (int(np.prod(shape)) * 8 - 1) >> 5
    assert top >> 5 == last or (top >> 5 == last - 1 and
                                int(np.prod(shape)) * 8 % 32 == 8)


def test_cells_past_n_cells_are_dead(cuda_device):
    """Cell lists whose tail past n_cells holds live-looking cells (the
    first cells again), cut at 0, inside a tile and at a tile's edge."""
    _, fine = _grids(33)
    occ = fine[1:, 1:, 1:].contiguous()
    cx, cy, cz, n_cells = _active(occ, max_cells=1 << 14)
    n = int(n_cells)
    cx, cy, cz = (torch.cat([c[:n], c[:n]]) for c in (cx, cy, cz))
    for cut in (0, 5 * km.EMIT_TILE_CELLS + 3, 7 * km.EMIT_TILE_CELLS, n):
        cells = (cx, cy, cz, torch.tensor(cut))
        got = _wrappers(occ.to(cuda_device),
                        [c.to(cuda_device) for c in cells], 0.5, 1 << 16,
                        1 << 16)
        _held(*got, occ, cells, 0.5, 1 << 16, 1 << 16)


def test_tied_corners(cuda_device):
    """Edges whose ends differ by less than 1e-12 take t = 0.5; the grid
    mixes tied crossings (1e-20 against -1e-20 or 0 about iso 0) with
    ordinary ones."""
    rng = np.random.RandomState(3)
    grid = rng.choice(np.array([1e-20, -1e-20, 0.5, -0.5, 0.0], np.float32),
                      size=(21, 18, 25))
    lo, hi = grid[..., :-1], grid[..., 1:]
    assert ((lo > 0) & (hi <= 0) & (np.abs(hi - lo) < 1e-12)).any()
    occ = torch.from_numpy(grid)
    cells = _active(occ, iso=0.0)
    got = _wrappers(occ.to(cuda_device), [c.to(cuda_device) for c in cells],
                    0.0, 1 << 16, 1 << 16)
    nt, _ = _held(*got, occ, cells, 0.0, 1 << 16, 1 << 16)
    assert nt > 1000


def test_look_back_over_many_tiles(cuda_device):
    """More than 1,000 tiles of cells in mt_emit's scan (wavy sheets across
    a 129^3 grid, 261,031 live cells) and more than 1,000 tiles of summary
    words in mt_index's (a box in a 352 x 320 x 300 grid); both held to
    plain on the card."""
    z, y, x = torch.meshgrid(*(torch.arange(129.0, device=cuda_device),) * 3,
                             indexing="ij")
    sheets = (0.5 + 0.4 * torch.sin(2 * np.pi * z / 24 + 0.6 * torch.sin(
        x / 7) + 0.6 * torch.sin(y / 5))).contiguous()
    cells = _active(sheets, max_cells=1 << 19)
    assert int(cells[3]) > 1000 * km.EMIT_TILE_CELLS
    got = _wrappers(sheets, cells, 0.5, 1 << 21, 1 << 21)
    _held(*got, sheets, cells, 0.5, 1 << 21, 1 << 21)
    shape = (352, 320, 300)
    assert km.index_sizes(1, shape)["scan"] - 1 > 1000
    box = torch.zeros(shape, device=cuda_device)
    box[100:140, 200:230, 50:95] = 1.0
    cells = _active(box)
    got = _wrappers(box, cells, 0.5, 1 << 16, 1 << 16)
    nt, _ = _held(*got, box, cells, 0.5, 1 << 16, 1 << 16)
    assert nt > 1000


def test_same_buffers_twice_leave_no_dirty_state(cuda_device):
    """One set of buffers (emit_buffers, index_buffers) through four
    surfaces in a row, the bitmap, the summary and both scans' scratch
    filled with ones before each (the C entries zero what they need), and
    the wrappers likewise: each call equals plain, so no call sees a bit,
    a summary bit or a scan status of the one before."""
    shape = (40, 57, 71)
    a = _far_corner(shape)
    b = torch.flip(a, (0, 1, 2)).contiguous()
    eb = km.emit_buffers(1 << 14, 1 << 15, cuda_device)
    ib = km.index_buffers(1 << 15, 1 << 15, shape, cuda_device)
    for occ in (a, b, a, b):
        cells = _active(occ, max_cells=1 << 14)
        dev_cells = [c.to(cuda_device) for c in cells]
        for buf in (ib.bitmap, ib.summary, ib.scan, eb.scan):
            buf.fill_(-1)
        got = _on_buffers(eb, ib, occ.to(cuda_device), dev_cells, 0.5,
                          1 << 15, 1 << 15)
        _held(*got, occ, cells, 0.5, 1 << 15, 1 << 15)
        got = _wrappers(occ.to(cuda_device), dev_cells, 0.5, 1 << 15,
                        1 << 15)
        _held(*got, occ, cells, 0.5, 1 << 15, 1 << 15)


def test_wrappers_keep_nothing_between_calls(cuda_device):
    """On a 513^3 grid (a sphere of radius 100) a wrapper call holds
    nothing once its outputs are dropped: its bitmap (135 MB), summary and
    scan scratch are its own and go back to the allocator, so
    memory_allocated returns to where it started."""
    z, y, x = torch.meshgrid(*(torch.arange(513.0, device=cuda_device),) * 3,
                             indexing="ij")
    occ = (1.0 - ((x - 256) ** 2 + (y - 250) ** 2 + (z - 260) ** 2).sqrt()
           / 200.0).contiguous()
    del z, y, x
    cells = _active(occ, max_cells=1 << 20)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(cuda_device)
    got = _wrappers(occ, cells, 0.5, 1 << 21, 1 << 21)
    assert int(got[0][4]) > 500000
    del got
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) == start


def test_two_host_threads_on_one_stream(cuda_device):
    """Two host threads call the wrappers on one stream at once, on
    different grids, many times over: first mt_index on each grid's
    emitted slots, then mt_emit. Every result is bit-identical to the plain
    versions', so no call reads a summary bit, a scan status or a ticket
    of a call whose launches interleave with its own."""
    grids = [_grids(n)[1][1:, 1:, 1:].contiguous().to(cuda_device)
             for n in (33, 25)]
    mt, mv, reps = 1 << 15, 1 << 15, 300
    cells = [_active(g, max_cells=1 << 14) for g in grids]
    plain = [_plain(g, c, 0.5, mt, mv) for g, c in zip(grids, cells)]
    emitted = [km.mt_emit(g, *c, 0.5, mt) for g, c in zip(grids, cells)]
    torch.cuda.synchronize()
    got = [{"index": [], "emit": []} for _ in grids]
    start = threading.Barrier(len(grids))

    def work(i):
        g, c, e = grids[i], cells[i], emitted[i]
        start.wait()
        for _ in range(reps):
            got[i]["index"].append(km.mt_index(*e[:5], mv, tuple(g.shape)))
        start.wait()
        for _ in range(reps):
            got[i]["emit"].append(km.mt_emit(g, *c, 0.5, mt))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(grids))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # the threads trade the GIL often
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    bad = []
    for i, (pe, pi) in enumerate(plain):
        nt, nu = int(pe[4]), min(int(pi[4]), mv)
        assert nt > 1000
        for r, gi in enumerate(got[i]["index"]):
            same = int(gi[4]) == int(pi[4]) and torch.equal(gi[3], pi[3]) \
                and all(torch.equal(gi[k][:nu], pi[k][:nu])
                        for k in range(3))
            if not same:
                bad.append(("mt_index", i, r))
        for r, ge in enumerate(got[i]["emit"]):
            same = [int(ge[4]), int(ge[5])] == [nt, int(pe[5])] and \
                torch.equal(ge[3], pe[3]) and \
                all(torch.equal(ge[k][:nt], pe[k][:nt]) for k in range(3))
            if not same:
                bad.append(("mt_emit", i, r))
    assert not bad, f"{len(bad)} of {4 * reps} calls differ: {bad[:8]}"


def test_wrappers_count_one_launch_each(cuda_device):
    _, fine = _grids(33)
    occ = fine[1:, 1:, 1:].contiguous()
    cells = _active(occ)
    before = (km.launches_emit, km.launches_index)
    _wrappers(occ.to(cuda_device), [c.to(cuda_device) for c in cells], 0.5,
              1 << 16, 1 << 16)
    assert (km.launches_emit, km.launches_index) == (before[0] + 1,
                                                     before[1] + 1)


@pytest.mark.parametrize("fill", [None, 0.0])
def test_unfilled_rows_reach_no_output(cuda_device, fill):
    """mt_emit's tv and mt_index's vertex rows past the counts are no
    longer zeroed: the soup (marching_tetrahedra, whose clamp gathers row 0
    for dead faces and the last row past max_verts) and both pack wires
    equal the CPU's, on a surface, with a max_verts cut, and on an empty
    grid."""
    _, fine = _grids(33)
    occ = fine[1:, 1:, 1:].contiguous() if fill is None else \
        torch.full((17, 19, 23), fill)
    for max_tris in (1 << 15, 700):
        got = PM.marching_tetrahedra(occ.to(cuda_device), max_tris=max_tris)
        want = PM.marching_tetrahedra(occ, max_tris=max_tris)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    kw = dict(max_cells=1 << 14, max_tris=1 << 15, max_verts=1 << 15)
    out = PM.marching_tetrahedra_indexed(occ.to(cuda_device), **kw)
    ref = PM.marching_tetrahedra_indexed(occ, **kw)
    for quantize in (False, True):
        g = PM.fetch_mesh(out, quantize=quantize)
        w = PM.fetch_mesh(ref, quantize=quantize)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
