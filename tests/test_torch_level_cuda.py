"""The level kernels (``level_upsample``, ``level_mark``, ``level_compact``,
``level_write``) against their plain PyTorch twins on the card, and the
serving frames' CUDA graphs against eager dispatch.

Every kernel rounds each operation as its twin does, so the outputs are
bit-identical: the fine occupancy, flags and mixed words, the dilated
words and block counts, the indices, points and counts, the written grid;
at the frame's level shapes (33^3 -> 65^3 with the 9^3 box, 65^3 -> 129^3
with the 7^3 one, and the 3^3 box) and the 257^3 upsample. Then a
``("step", lv, budget)`` graph and the filter graph replayed with a new
``cross_z`` equal eager calls bit for bit, and the kNN wrapper and
``fast_winding``, each captured in a ``torch.cuda.graph``, replay bit-equal
to eager calls.

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_level_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import level as kl
from icon_tpu_torch.kernels.knn import nearest_vertices_kernel
from icon_tpu_torch.ops import sdf_fast as sf
from icon_tpu_torch.recon.graphs import GraphedCall
from icon_tpu_torch.utils.synthetic import synthetic_body

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the level kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _coarse(rc, dev, seed=0):
    """A coarse occupancy [rc]^3 like a level's: a sharp ellipsoid, seeded
    noise, exact 0.5 values, and flags of the voxels "evaluated" (every
    one, or a seeded half)."""
    rng = np.random.RandomState(seed)
    g = np.linspace(-1.0, 1.0, rc, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    rad = np.sqrt((x / 0.5) ** 2 + (y / 0.8) ** 2 + (z / 0.3) ** 2)
    occ = 1.0 / (1.0 + np.exp((rad - 1.0) * 12.0))
    occ = occ + rng.randn(*occ.shape) * 0.02
    occ[rng.rand(*occ.shape) < 0.01] = 0.5
    ev = rng.rand(*occ.shape) < 0.5 if seed else np.ones(occ.shape, bool)
    return (torch.from_numpy(occ.astype(np.float32)).to(dev),
            torch.from_numpy(ev).to(dev))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w), \
            f"{int((g != w).sum())} of {g.numel()} entries differ"


@pytest.mark.parametrize("rc,k,seed", [(33, 9, 0), (65, 7, 1), (65, 3, 2)])
def test_kernels_match_plain(cuda_device, rc, k, seed):
    occ_c, ev_c = _coarse(rc, cuda_device, seed)
    r = 2 * rc - 1
    up = kl._upsample_marks(occ_c, ev_c)
    _same(up, kl.upsample_marks_plain(occ_c, ev_c))
    marks = kl._mark(up[2], ev_c, r, k)
    _same(marks, kl.mark_plain(up[2], ev_c, r, k))
    total = int(marks[1].sum())
    assert total > 1000
    for budget in (total // 3, total, total + 4097):
        out = kl._compact_words(*marks, r, budget)
        _same(out, kl.compact_words_plain(marks[0], r, budget))
        vals = torch.rand(budget, device=cuda_device)
        occ_f, ev_f = up[0].clone(), up[1].clone()
        kl._write(occ_f, ev_f, out[0], out[2], vals)
        _same((occ_f, ev_f), kl.write_plain(up[0], up[1], out[0], out[2],
                                            vals))
    _same(kl.level_select(occ_c, ev_c, k, total // 2),
          kl.level_select_plain(occ_c, ev_c, k, total // 2))


def test_upsample_257(cuda_device):
    occ_c, _ = _coarse(129, cuda_device)
    before = kl.launches_upsample
    got = kl.upsample(occ_c)
    assert kl.launches_upsample == before + 1
    _same((got,), (kl.upsample_plain(occ_c),))


def test_pack_and_compact_a_mask(cuda_device):
    """Byte mode (exact mode's conflict flags) at a width of 32 words and
    one bit past: r = 129."""
    rng = np.random.RandomState(3)
    mask = torch.from_numpy(rng.rand(129, 129, 129) < 0.002).to(cuda_device)
    _same(kl._pack(mask), kl.pack_plain(mask))
    _same(kl.compact(mask, 3000), kl.compact_points_plain(mask, 3000))


def test_no_boundary_and_empty_budget(cuda_device):
    occ_c = torch.zeros((33, 33, 33), device=cuda_device)
    ev_c = torch.ones((33, 33, 33), dtype=torch.bool, device=cuda_device)
    got = kl.level_select(occ_c, ev_c, 9, 64)
    _same(got, kl.level_select_plain(occ_c, ev_c, 9, 64))
    assert got[4].tolist() == [0, 0, 0]
    assert bool((got[2] == 65 ** 3 - 1).all())
    _same(kl.level_select(occ_c, ev_c, 9, 0),
          kl.level_select_plain(occ_c, ev_c, 9, 0))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    occ_c, ev_c = _coarse(9, cuda_device)
    with pytest.raises(ValueError):
        kl.level_select(occ_c[:, :, :8], ev_c, 3, 10)
    with pytest.raises(TypeError):
        kl.level_select(occ_c.double(), ev_c, 3, 10)
    with pytest.raises(ValueError):
        kl.level_select(occ_c, ev_c, 4, 10)
    with pytest.raises(ValueError):
        kl.upsample(occ_c.transpose(0, 2))


def _small_frame(dev, sign="columns"):
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(1), B=1,
                                 image_size=64, n_samples=8, subdiv=3)
    return build_frame(cfg, seeded_state(cfg, 1), batch, 128, dev,
                       sign=sign)


def test_step_and_filter_graphs_replay_bit_equal(cuda_device):
    """The engine's graphs (level 0, each (level, budget) step with its
    query, the final upsample) and the filter graph, replayed with a new
    cross_z twice, equal eager calls on the same inputs bit for bit; the
    stats of each graph call are its own."""
    fr = _small_frame(cuda_device)
    assert fr.graphs
    cross_z, _ = fr.columns()
    feats = fr.features()
    eager_feats = fr.features.fn()
    torch.cuda.synchronize()
    _same(tuple(feats), tuple(eager_feats))
    shifted = cross_z + 0.015
    kept = []
    for cz in (cross_z, shifted, cross_z, shifted):
        feats = fr.features()
        occ_g, st_g = fr.engine(fr.query_fn, query_args=(cz, feats),
                                graph_levels=True)
        occ_g = occ_g.clone()
        occ_e, st_e = fr.engine(fr.query_fn, query_args=(cz, feats))
        torch.cuda.synchronize()
        _same((occ_g, st_g["coarse_occ"]), (occ_e, st_e["coarse_occ"]))
        for key in st_e:
            if key.startswith("level"):
                assert int(st_g[key]) == int(st_e[key]), key
        kept.append((st_g, st_e))
    # the new cross_z reached the graphs' queries
    assert not torch.equal(kept[0][0]["coarse_occ"], kept[1][0]["coarse_occ"])
    for st_g, st_e in kept:               # each call's stats are its own
        _same((st_g["coarse_occ"], st_g["level1_points"]),
              (st_e["coarse_occ"], st_e["level1_points"]))
    assert sum(c.replays for c in fr.engine._graphs.values()) >= 12


def test_graph_levels_needs_the_faster_mode(cuda_device):
    from icon_tpu_torch.recon.engine import ReconEngine
    eng = ReconEngine((17, 33), exact=True, device=cuda_device)
    with pytest.raises(ValueError):
        eng(lambda p: p[..., :1], graph_levels=True)


def test_knn_and_winding_replay_in_a_graph(cuda_device):
    """The kNN wrapper and fast_winding captured in a torch.cuda.graph and
    replayed on new points copied into the captured buffer: each equals
    an eager call on those points bit for bit (the graph ROADMAP B4 asks
    of the kNN first)."""
    v, f = synthetic_body(subdiv=4)
    verts = torch.from_numpy(v).to(cuda_device)
    faces = torch.from_numpy(f).long().to(cuda_device)
    cf, cm = sf.build_winding_clusters(v, f)
    cf = torch.from_numpy(cf).long().to(cuda_device)
    cm = torch.from_numpy(cm).to(cuda_device)
    rng = np.random.RandomState(5)

    def points():
        p = v[rng.randint(0, len(v), 20000)] + 0.03 * rng.randn(20000, 3)
        return torch.from_numpy(p.astype(np.float32)).to(cuda_device)

    def both(p):
        idx, key = nearest_vertices_kernel(p, verts, 2)
        return idx, key, sf.fast_winding(p, verts, faces, cf, cm)

    call = GraphedCall(both)
    for _ in range(3):
        p = points()
        got = tuple(t.clone() for t in call(p))
        want = both(p)
        torch.cuda.synchronize()
        _same(got, want)
    assert call.replays == 3
