"""Port parity, the engine's level step: the plain twins of
``icon_tpu_torch/kernels/level.py`` (what a CPU tensor runs, and what the
level kernels are held to on the card) against the JAX package's own
functions, bit for bit, on seeded numpy inputs.

The level step of ``icon_tpu.recon.engine.ReconEngine._level_step`` at
the levels of (17, 33, 65) and of (9, 17, 33, 65) (the 9^3, 7^3 and 3^3
boxes) on a field that both packages evaluate exactly (dyadic grid points,
exact products and sums), with occupancies of exactly 0.5, with budgets
below, at and above the boundary count, and on grids with no boundary;
``_compact``; ``_upsample`` (normal numbers: XLA's CPU flushes subnormal
results to zero, torch does not); ``smooth_conv3d(b, k) > 0`` against the box
OR at the borders; the kernels' packed twins composed against the plain
level. A CPU engine refuses ``graph_levels``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icon_tpu.ops import voxelize as jvox
from icon_tpu.recon import engine as J
from icon_tpu_torch.kernels import level as kl
from icon_tpu_torch.recon import engine as P

jax.config.update("jax_platforms", "cpu")


def jfield(pts):
    """0.5 + 16 (0.375 - |p|^2) clipped: exact on the dyadic grid points
    of both packages, 0.5 on the sphere |p|^2 = 0.375."""
    s = jnp.sum(pts * pts, axis=-1, keepdims=True)
    return jnp.clip(0.5 + 16.0 * (0.375 - s), 0.0, 1.0)


def pfield(pts):
    s = torch.sum(pts * pts, dim=-1, keepdim=True)
    return torch.clamp(0.5 + 16.0 * (0.375 - s), 0.0, 1.0)


def _coarse(rc, seed, kind="field"):
    """(occ, evaluated) [rc]^3 as numpy: the field on the grid with seeded
    noise and 0.5 entries, or a grid with no boundary."""
    rng = np.random.RandomState(seed)
    if kind == "empty":
        return (np.zeros((rc,) * 3, np.float32),
                np.ones((rc,) * 3, bool))
    if kind == "full":
        return (np.ones((rc,) * 3, np.float32),
                rng.rand(rc, rc, rc) < 0.5)
    g = np.linspace(-1.0, 1.0, rc, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    occ = np.clip(0.5 + 16.0 * (0.375 - (x * x + y * y + z * z)), 0, 1)
    occ = occ + np.where(rng.rand(rc, rc, rc) < 0.1,
                         rng.randn(rc, rc, rc) * 0.25, 0.0)
    occ[rng.rand(rc, rc, rc) < 0.05] = 0.5
    ev = rng.rand(rc, rc, rc) < 0.7
    return occ.astype(np.float32), ev


def _jax_step(res, lv, occ, ev, budget):
    eng = J.ReconEngine(res, faster=True)
    o, e, total, _ = eng._level_step(lv, jnp.asarray(occ), jnp.asarray(ev),
                                     jfield, budget=budget)
    return np.asarray(o), np.asarray(e), int(total)


def _port_step(res, lv, occ, ev, budget):
    eng = P.ReconEngine(res, device="cpu")
    o, e, counts, _, _ = eng._level_step(lv, torch.from_numpy(occ),
                                         torch.from_numpy(ev), pfield,
                                         budget, ())
    return o.numpy(), e.numpy(), counts


@pytest.mark.parametrize("res,lv,kind", [
    ((17, 33, 65), 1, "field"), ((17, 33, 65), 2, "field"),
    ((9, 17, 33, 65), 3, "field"), ((17, 33, 65), 1, "empty"),
    ((17, 33, 65), 2, "full")])
@pytest.mark.parametrize("share", [0.5, 1.0, 2.0])
def test_level_step_bit_equal(res, lv, kind, share):
    rc = res[lv - 1]
    occ, ev = _coarse(rc, lv * 7 + len(res), kind)
    total = int(_port_step(res, lv, occ, ev, 8)[2][1])
    budget = max(int(total * share), 1) if total else 64
    jo, je, jt = _jax_step(res, lv, occ, ev, budget)
    po, pe, counts = _port_step(res, lv, occ, ev, budget)
    assert int(counts[1]) == jt == total
    assert counts.tolist() == [min(jt, budget), jt, max(jt - budget, 0)]
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(po.view(np.int32), jo.view(np.int32))
    if kind == "field":
        assert total > 100 and (po == 0.5).any()
    else:
        assert total == 0


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0, 1.5])
def test_compact_bit_equal(share):
    rng = np.random.RandomState(int(share * 10))
    mask = rng.rand(33 ** 3) < 0.02
    budget = max(int(mask.sum() * share), 1)
    ji, jn, jt = J._compact(jnp.asarray(mask), budget)
    pi, pn, pt = kl.compact_plain(torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (int(pn), int(pt)) == (int(jn), int(jt))
    idx, pts, counts = kl.compact_points_plain(
        torch.from_numpy(mask.reshape(33, 33, 33)), budget)
    assert torch.equal(idx, pi)
    assert counts.tolist() == [int(jn), int(jt), max(int(jt) - budget, 0)]


@pytest.mark.parametrize("rc", [9, 33])
def test_upsample_bit_equal(rc):
    rng = np.random.RandomState(rc)
    occ = rng.rand(rc, rc, rc).astype(np.float32)
    occ[rng.rand(rc, rc, rc) < 0.2] = 0.5
    occ[rng.rand(rc, rc, rc) < 0.1] = 1.0
    r = 2 * rc - 1
    want = np.asarray(J.ReconEngine((rc, r))._upsample(jnp.asarray(occ), r))
    got = kl.upsample(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert torch.equal(P.ReconEngine((rc, r), device="cpu")._upsample(
        torch.from_numpy(occ), r), torch.from_numpy(got))


@pytest.mark.parametrize("k", [3, 7, 9])
def test_dilation_is_the_smooth_above_zero(k):
    """``smooth_conv3d(b, k) > 0`` of the JAX package is the zero-padded
    k^3 box OR of the kernels' mark twin, at the borders too."""
    rng = np.random.RandomState(k)
    r = 33
    b = rng.rand(r, r, r) < 0.002
    b[0, 0, 0] = b[r - 1, r - 1, r - 1] = b[0, r - 1, 5] = True
    b[r // 2, 0, r - 1] = True
    want = np.asarray(jvox.smooth_conv3d(
        jnp.asarray(b, jnp.float32)[None, ..., None], k))[0, ..., 0] > 0
    words, counts = kl.mark_plain(kl.pack_rows(torch.from_numpy(b)), None,
                                  r, k)
    got = kl.unpack_rows(words, r).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(counts.sum()) == int(want.sum())
    box = torch.nn.functional.max_pool3d(
        torch.from_numpy(b).float()[None, None], k, 1, k // 2)[0, 0] > 0
    np.testing.assert_array_equal(got, box.numpy())


@pytest.mark.parametrize("rc,k", [(9, 9), (17, 7), (17, 3)])
def test_kernel_twins_compose_to_the_level(rc, k):
    """The packed twins of upsample-with-marks, mark and compact, then the
    write, give the plain level step bit for bit."""
    occ, ev = (torch.from_numpy(a) for a in _coarse(rc, rc + k))
    r = 2 * rc - 1
    occ_f, ev_f, raw = kl.upsample_marks_plain(occ, ev)
    words, counts = kl.mark_plain(raw, ev, r, k)
    total = int(counts.sum())
    for budget in (total // 2, total, total + 100):
        idx, pts, cnt = kl.compact_words_plain(words, r, budget)
        want = kl.level_select_plain(occ, ev, k, budget)
        for got, ref in zip((occ_f, ev_f, idx, pts, cnt), want):
            assert torch.equal(got, ref)
        vals = torch.linspace(0.0, 1.0, budget)
        o, e = kl.level_write(occ_f, ev_f, idx, cnt, vals)
        live = idx[:int(cnt[0])]
        assert torch.equal(o.reshape(-1)[live], vals[:int(cnt[0])])
        assert bool(e.reshape(-1)[live].all())
        assert int(e.sum()) == int(ev_f.sum()) + int(cnt[0])


def test_pack_rows_round_trip():
    rng = np.random.RandomState(2)
    for r in (1, 31, 32, 33, 65):
        m = torch.from_numpy(rng.rand(r, r, r) < 0.5)
        words = kl.pack_rows(m)
        assert words.shape == (r * r, -(-r // 32)) and \
            words.dtype == torch.int32
        assert torch.equal(kl.unpack_rows(words, r), m)


def test_graph_levels_on_a_cpu_engine_raises():
    eng = P.ReconEngine((9, 17, 33), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        eng(pfield, graph_levels=True)
    occ, stats = eng(pfield)
    assert occ.shape == (33, 33, 33) and int(stats["level1_points"]) > 0
