"""The lattice kernels (``lattice_cells``, ``lattice_emit``,
``lattice_decode``) against their plain PyTorch twins on the card, and the
card's serving marcher against the host decoder.

Every kernel rounds each operation as its twin does, so the outputs are
bit-identical: the cells' coordinates, ids, corner values and counts; the
lattice's edge ids, fractions, corner bytes and counts; the decoded
header, vertices and faces. The cells kernel also on the layouts its wide
tiles make delicate (``tests/lattice_layouts.py``); the emit's rank
tables against ``rank_tables_plain``, on cooperative grids of 1 and 7
blocks and the default, on overflowed emits, from the rank entry on a
released lattice and from a CUDA graph's replays; the decode of a
lattice without them (released, or from the plain emit).

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_lattice_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import sys
import threading

import numpy as np
import pytest
import torch

from lattice_layouts import LAYOUTS, fine_of

from icon_tpu_torch.kernels import lattice as kl
from icon_tpu_torch.ops.resize import resize3d_trilinear_align_corners
from icon_tpu_torch.recon import lattice_host as PH
from icon_tpu_torch.recon import marching as PM

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lattice kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _grids(n, device, seed=None):
    """A lumpy ellipsoid (or, with ``seed``, uniform noise) at n^3, and its
    2x align_corners upsample as the engine holds it: the full grid and
    its view sliced by one."""
    if seed is None:
        g = np.linspace(-1, 1, n, dtype=np.float32)
        z, y, x = np.meshgrid(g, g, g, indexing="ij")
        r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2)
        r = r + 0.08 * np.sin(7 * x) * np.sin(5 * y)
        coarse = (1.0 / (1.0 + np.exp((r - 0.8) * 12))).astype(np.float32)
    else:
        coarse = np.random.RandomState(seed).rand(n, n, n).astype(np.float32)
    coarse = torch.from_numpy(coarse).to(device)
    full = resize3d_trilinear_align_corners(coarse[None, None],
                                            (2 * n - 1,) * 3)[0, 0]
    return coarse, full[1:, 1:, 1:]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _decode_equal(buf, want, nvb, nfb) -> bool:
    """The kernel's decode buffer equals the twin's on the header and the
    rows the counts cover."""
    h = [int(v) for v in want[:4]]
    nw, fw = min(h[0], nvb), min(h[1], nfb)
    fo = kl.HEADER + 3 * nvb
    return torch.equal(buf[:4].cpu(), want[:4].cpu()) and \
        torch.equal(buf[kl.HEADER:kl.HEADER + 3 * nw].cpu(),
                    want[kl.HEADER:kl.HEADER + 3 * nw].cpu()) and \
        torch.equal(buf[fo:fo + 3 * fw].cpu(), want[fo:fo + 3 * fw].cpu())


CASES = [(33, None, 1 << 15, 1 << 16), (65, None, 1 << 17, 1 << 18),
         (65, None, 3000, 1 << 18), (65, None, 1 << 17, 5000),
         (17, 0, 1 << 15, 1 << 16)]


@pytest.mark.parametrize("coarse_path", [True, False])
@pytest.mark.parametrize("n,seed,max_cells,max_verts", CASES)
def test_kernels_equal_plain(cuda_device, n, seed, max_cells, max_verts,
                             coarse_path):
    coarse, occ = _grids(n, cuda_device, seed)
    cg = coarse if coarse_path else None
    cells = kl.lattice_cells(occ, 0.5, max_cells, cg)
    want = kl.lattice_cells_plain(occ, 0.5, max_cells, cg)
    assert _equal(cells, want) and int(cells.n_cells) > 100
    args = (cells.cx, cells.cy, cells.cz, cells.cell_idx, cells.n_cells,
            cells.n_cells_total, tuple(occ.shape), 0.5, max_verts)
    out = kl.lattice_emit(cells.cvals, *args)
    ref = kl.lattice_emit_plain(cells.cvals, *args)
    assert _equal(out[:8], ref[:8]) and out.grid_shape == ref.grid_shape
    for nvb, nfb in (kl.decode_sizes(out), (1000, 2000)):
        buf = kl.lattice_decode(out, nvb, nfb)
        assert _decode_equal(buf, kl.lattice_decode_plain(ref, nvb, nfb),
                             nvb, nfb)


@pytest.mark.parametrize("max_cells", [1 << 14, 40])
@pytest.mark.parametrize("coarse_path", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_equal_plain(cuda_device, layout, coarse_path, max_cells):
    """The budget's last mixed coarse cell at a tile's edge, ragged sides,
    mixed cells on every face, a single mixed cell, an empty grid: the
    kernel's cells bit-equal to the twin's, twice (the scratch reused)."""
    coarse, max_candidates = LAYOUTS[layout]()
    occ = torch.from_numpy(fine_of(coarse)).to(cuda_device)
    cg = torch.from_numpy(coarse).to(cuda_device) if coarse_path else None
    want = kl.lattice_cells_plain(occ, 0.5, max_cells, cg, max_candidates)
    for _ in range(2):
        got = kl.lattice_cells(occ, 0.5, max_cells, cg, max_candidates)
        assert _equal(got, want)


def _tables_equal(tables, want) -> bool:
    """Rank tables on the card equal ``rank_tables_plain``'s where the
    decode reads them: the summary, the touched summary words' rows, the
    touched words' rows."""
    n_sum = want[0].shape[0]
    summary = tables[0].view(torch.int32)[:n_sum].to(torch.int64) & \
        0xFFFFFFFF
    touched = want[0] != 0
    sum_rank = tables[1].to(torch.int64) & 0xFFFFFFFF
    n = want[2].shape[0]
    word_rank = tables[2][:n].to(torch.int64) & 0xFFFFFFFF
    return torch.equal(summary, want[0]) and \
        torch.equal(sum_rank[touched], want[1][touched]) and \
        torch.equal(word_rank, want[2])


def test_rank_tables_equal_plain(cuda_device):
    """The emit's rank tables (kept on the lattice) and the decode's own
    build of them equal rank_tables_plain where the decode reads them:
    the summary, the touched summary words' rows, the touched words'."""
    coarse, occ = _grids(65, cuda_device)
    for max_verts in (1 << 18, 5000):
        out = PM.marching_lattice(occ, max_cells=1 << 17,
                                  max_verts=max_verts, coarse_occ=coarse)
        want = kl.rank_tables_plain(out.vert_eid, out.n_verts,
                                    out.grid_shape)
        assert want[2].shape[0] > 500
        for tables in (out.rank, kl._rank_tables(out, kl._lib_on(
                cuda_device))):
            assert _tables_equal(tables, want)


@pytest.mark.parametrize("blocks", [1, 7, None])
def test_emit_grids_and_overflow(cuda_device, monkeypatch, blocks):
    """The cooperative emit and rank entry on a grid of 1 block, 7 blocks
    and the default (2 an SM): outputs bit-equal to the twin's, the rank
    tables equal to rank_tables_plain's, with every vertex kept and with
    max_verts below the total (5000, and 777, no multiple of a block),
    where ids reach max_verts and the dropped ones must not be marked."""
    if blocks:                        # a card of `blocks` SMs, one a block
        monkeypatch.setattr(kl, "EMIT_BLOCKS_PER_SM", 1)
        monkeypatch.setattr(kl, "_sm_count", lambda index: blocks)
    coarse, occ = _grids(65, cuda_device)
    cells = kl.lattice_cells(occ, 0.5, 1 << 17, coarse)
    lib = kl._lib_on(cuda_device)
    for max_verts in (1 << 18, 5000, 777):
        args = (cells.cx, cells.cy, cells.cz, cells.cell_idx, cells.n_cells,
                cells.n_cells_total, tuple(occ.shape), 0.5, max_verts)
        out = kl.lattice_emit(cells.cvals, *args)
        ref = kl.lattice_emit_plain(cells.cvals, *args)
        assert _equal(out[:8], ref[:8])
        assert (int(ref.n_verts_total) > max_verts) == (max_verts < 1 << 18)
        want = kl.rank_tables_plain(ref.vert_eid, ref.n_verts,
                                    ref.grid_shape)
        assert _tables_equal(out.rank, want)
        assert _tables_equal(kl._rank_tables(out, lib), want)
        sizes = kl.decode_sizes(out)
        assert _decode_equal(kl.lattice_decode(out, *sizes),
                             kl.lattice_decode_plain(ref, *sizes), *sizes)


def test_rank_entry_on_a_released_lattice(cuda_device):
    """A released lattice's tables built anew by the rank entry (one
    cooperative launch) equal the emit's own, and its decode the twin's."""
    coarse, occ = _grids(33, cuda_device)
    out = PM.marching_lattice(occ, max_cells=1 << 15, max_verts=1 << 16,
                              coarse_occ=coarse)
    emitted = [t.clone() for t in out.rank]
    kl.release_rank(out)
    rebuilt = kl._rank_tables(out, kl._lib_on(cuda_device))
    want = kl.rank_tables_plain(out.vert_eid, out.n_verts, out.grid_shape)
    assert _tables_equal(emitted, want) and _tables_equal(rebuilt, want)
    sizes = kl.decode_sizes(out)
    assert _decode_equal(kl.lattice_decode(out, *sizes),
                         kl.lattice_decode_plain(out, *sizes), *sizes)


def test_emit_in_a_cuda_graph(cuda_device):
    """lattice_emit captured in a CUDA graph (its one cooperative launch)
    and replayed on new cells of the same shapes, copied into the
    captured inputs: each replay's outputs and rank tables bit-equal to
    the twin's on those cells."""
    mc, mv = 1 << 15, 1 << 16
    inputs = []
    for seed in (None, 0):
        coarse, occ = _grids(33, cuda_device, seed)
        inputs.append(kl.lattice_cells_plain(occ, 0.5, mc, coarse))
    shape = tuple(occ.shape)
    static = [t.clone() for t in inputs[0]]

    def emit(c):
        return kl.lattice_emit(c[4], c[0], c[1], c[2], c[3], c[5], c[6],
                               shape, 0.5, mv)

    emit(static)                      # binds the library and sizes the grid
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = emit(static)
    for cells in (inputs[1], inputs[0], inputs[1]):
        for dst, src in zip(static, cells):
            dst.copy_(src)
        graph.replay()
        ref = kl.lattice_emit_plain(cells.cvals, *cells[:4], *cells[5:],
                                    shape, 0.5, mv)
        torch.cuda.synchronize()
        assert _equal(out[:8], ref[:8]) and int(ref.n_verts) > 1000
        assert _tables_equal(out.rank, kl.rank_tables_plain(
            ref.vert_eid, ref.n_verts, ref.grid_shape))


def test_decode_without_the_emits_tables(cuda_device):
    """A lattice whose tables were released, or from the plain emit, is
    decoded through tables built anew: the twin's buffer, each call."""
    coarse, occ = _grids(33, cuda_device)
    out = PM.marching_lattice(occ, max_cells=1 << 15, max_verts=1 << 16,
                              coarse_occ=coarse)
    sizes = kl.decode_sizes(out)
    want = kl.lattice_decode_plain(out, *sizes)
    assert _decode_equal(kl.lattice_decode(out, *sizes), want, *sizes)
    kl.release_rank(out)
    assert not out.rank
    before = kl.launches_decode
    for _ in range(2):
        assert _decode_equal(kl.lattice_decode(out, *sizes), want, *sizes)
    assert kl.launches_decode == before + 2 and not out.rank
    c = kl.lattice_cells_plain(occ, 0.5, 1 << 15, coarse)
    plain = kl.lattice_emit_plain(c.cvals, *c[:4], *c[5:],
                                  tuple(occ.shape), 0.5, 1 << 16)
    assert plain.rank is None
    assert _decode_equal(kl.lattice_decode(plain, *sizes), want, *sizes)


def test_candidate_budget_and_empty_grid(cuda_device):
    coarse, occ = _grids(33, cuda_device)
    got = kl.lattice_cells(occ, 0.5, 1 << 15, coarse, max_candidates=2400)
    want = kl.lattice_cells_plain(occ, 0.5, 1 << 15, coarse,
                                  max_candidates=2400)
    assert _equal(got, want) and int(got.n_cells_total) > int(got.n_cells)
    empty = torch.full((9, 10, 11), 0.25, device=cuda_device)
    out = PM.marching_lattice(empty, max_cells=64, max_verts=64)
    buf = kl.lattice_decode(out, 64, 64)
    assert buf[:4].tolist() == [0, 0, 0, 0]
    assert (out.vert_eid == kl.INT64_MAX).all()


def test_card_marcher_serves_the_host_decoders_mesh(cuda_device):
    """The card's AutoMarcher decodes on the card: its meshes, served
    frame after frame, equal the host decoder's on the same march (wire v1
    and v2), and no host decode runs."""
    coarse, occ = _grids(65, cuda_device)
    m = PM.AutoMarcher(max_cells=1 << 18, max_verts=1 << 19,
                       slice_one=False, codec="lattice")
    D, H, W = occ.shape
    for _ in range(4):
        before = (kl.launches_cells, kl.launches_emit, kl.launches_decode,
                  PH.host_decodes)
        out = m(occ, coarse_occ=coarse)
        token = m.pack(out)
        verts, faces = m.unpack(token)
        assert (kl.launches_cells, kl.launches_emit, kl.launches_decode,
                PH.host_decodes) == tuple(b + d for b, d in
                                          zip(before, (1, 1, 1, 0)))
        for implicit in (False, True):
            hv, hf = PM.decode_lattice(PM.pack_lattice(
                out, implicit_eid=implicit), H, W)
            np.testing.assert_array_equal(faces, hf)
            np.testing.assert_array_equal(verts.view(np.int32),
                                          hv.view(np.int32))
        assert len(faces) > 10000 and token[0][2] >= len(faces)
    c = m._counts()
    assert token[0][1:] == PM._pack_rows(
        (int(c[1] * m.headroom), int(12 * c[0] * m.headroom)),
        kl.decode_sizes(out))


def test_overflowed_decode_repacks(cuda_device):
    """A token whose decode buffer is below the frame's counts reports the
    overflow and re-packs at the header's counts."""
    coarse, occ = _grids(33, cuda_device)
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice")
    out = m(occ, coarse_occ=coarse)
    full = m.unpack(m.pack(out))
    small = kl.lattice_decode(out, 64, 64)
    token = ((PM.HostCopy(small), 64, 64), out, PM._DECODED)
    v, f, overflow = m.decode(token)
    assert overflow and len(f) == 64
    verts, faces = m.unpack(token)
    np.testing.assert_array_equal(faces, full[1])
    np.testing.assert_array_equal(verts, full[0])


def test_virtual_level_decodes_on_the_card(cuda_device):
    coarse, _ = _grids(33, cuda_device)
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice", virtual=True)
    out = m(coarse)
    verts, faces = m.unpack(m.pack(out))
    hv, hf = PM.decode_lattice(PM.pack_lattice(out), *m._dims)
    np.testing.assert_array_equal(faces, hf)
    np.testing.assert_array_equal(verts, hv)
    assert len(faces) > 1000


def test_two_host_threads_on_one_stream(cuda_device):
    """Two host threads call the three wrappers on one stream at once, on
    different grids, 200 times each (1,600 calls: the decode of the plain
    lattice, which builds its rank tables, and of the thread's own emit):
    every result is bit-identical to the plain twins', so no call reads a
    scan status, a ticket, a summary bit or a rank table of a call whose
    launches interleave with its own."""
    grids = [_grids(n, cuda_device) for n in (33, 25)]
    mc, mv, reps = 1 << 15, 1 << 16, 200
    plain = []
    for coarse, occ in grids:
        c = kl.lattice_cells_plain(occ, 0.5, mc, coarse)
        e = kl.lattice_emit_plain(c.cvals, *c[:4], *c[5:], tuple(occ.shape),
                                  0.5, mv)
        sizes = kl.decode_sizes(e)
        plain.append((c, e, kl.lattice_decode_plain(e, *sizes), sizes))
    torch.cuda.synchronize()
    got = [[] for _ in grids]
    start = threading.Barrier(len(grids))

    def work(i):
        (coarse, occ), (c, e, _, sizes) = grids[i], plain[i]
        start.wait()
        for _ in range(reps):
            got[i].append((
                kl.lattice_cells(occ, 0.5, mc, coarse),
                kl.lattice_emit(c.cvals, *c[:4], *c[5:], tuple(occ.shape),
                                0.5, mv),
                kl.lattice_decode(e, *sizes)))
            # the main path's decode: through its own emit's tables
            got[i][-1] += (kl.lattice_decode(got[i][-1][1], *sizes),)

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
    for i, (c, e, d, sizes) in enumerate(plain):
        assert int(d[1]) > 1000
        for r, (gc, ge, gd, gt) in enumerate(got[i]):
            if not _equal(gc, c):
                bad.append(("lattice_cells", i, r))
            if not _equal(ge[:8], e[:8]):
                bad.append(("lattice_emit", i, r))
            if not _decode_equal(gd, d, *sizes):
                bad.append(("lattice_decode", i, r))
            if not _decode_equal(gt, d, *sizes):
                bad.append(("lattice_decode (emit's tables)", i, r))
    assert not bad, f"{len(bad)} of {8 * reps} calls differ: {bad[:8]}"
