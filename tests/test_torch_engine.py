"""Port parity, recon engine: icon_tpu_torch.recon.engine against
icon_tpu.recon.engine in faster mode on analytic fields. Per-level counts
must be identical and grids agree to 1e-5 (the same field evaluated by two
float32 implementations)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import t

from icon_tpu.recon import engine as J
from icon_tpu_torch.recon import engine as P

AXES = np.array([0.45, 0.7, 0.2], np.float32)


def jfield(pts):
    rad = jnp.linalg.norm(pts / jnp.asarray(AXES), axis=-1, keepdims=True)
    return jax.nn.sigmoid((1.0 - rad) * 25.0)


def pfield(pts):
    rad = torch.linalg.norm(pts / t(AXES), dim=-1, keepdim=True)
    return torch.sigmoid((1.0 - rad) * 25.0)


def test_ladder_and_budgets():
    for r in (64, 128, 256, 512):
        assert P.reconstruction_resolutions(r) == \
            J.reconstruction_resolutions(r)
        res = P.reconstruction_resolutions(r)
        assert P.default_budgets(res) == J.default_budgets(res)
    assert P.reconstruction_resolutions(256) == (33, 65, 129, 257)


@pytest.mark.parametrize("density,budget", [(0.3, 50), (0.01, 50),
                                            (0.0, 8), (0.5, 3000)])
def test_compact_identical(density, budget):
    rng = np.random.RandomState(int(density * 100) + budget)
    mask = rng.rand(2000) < density
    ji, jn, jt = J._compact(jnp.asarray(mask), budget)
    pi, pn, pt = P._compact(t(mask), budget)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (int(pn), int(pt)) == (int(jn), int(jt))


def test_engine_parity_on_analytic_field():
    res = (17, 33, 65)
    jocc, jstats = J.ReconEngine(res, faster=True)(jfield)
    occ, stats = P.ReconEngine(res, device="cpu")(pfield)
    assert occ.shape == (65, 65, 65)
    for lv in (1,):
        assert int(stats[f"level{lv}_points"]) == \
            int(jstats[f"level{lv}_points"]) > 0
        assert int(stats[f"level{lv}_overflow"]) == \
            int(jstats[f"level{lv}_overflow"]) == 0
    np.testing.assert_allclose(stats["coarse_occ"].numpy(),
                               np.asarray(jstats["coarse_occ"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                               atol=1e-5)


def test_engine_budget_overflow_parity():
    """Budgets smaller than the boundary: both drop the same tail, report
    the same overflow and write the same grid."""
    res = (17, 33, 65)
    jocc, jstats = J.ReconEngine(res, budgets=(500, 500))(jfield)
    occ, stats = P.ReconEngine(res, budgets=(500, 500), device="cpu")(pfield)
    assert int(stats["level1_overflow"]) == int(jstats["level1_overflow"]) > 0
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                               atol=1e-5)


def test_auto_budget_shrinks_and_recovers():
    """As tests/test_engine.py:96: the bucket snaps to the measured count x
    headroom, the grid does not change with it, and an overflow resets to
    the cap. The port picks the same buckets as the JAX engine."""
    res = (33, 65, 129)
    jeng = J.ReconEngine(res, auto_budget=True)
    eng = P.ReconEngine(res, auto_budget=True, device="cpu")
    jocc1, js1 = jeng(jfield)
    occ1, s1 = eng(pfield)
    b_default = eng.budgets[0]
    b2 = eng._bucket(1)
    assert b2 == jeng._bucket(1)
    need = int(s1["level1_points"])
    assert need == int(js1["level1_points"])
    assert need <= b2 < b_default
    occ2, s2 = eng(pfield)
    assert float((occ1 - occ2).abs().max()) < 1e-6
    np.testing.assert_allclose(occ2.numpy(), np.asarray(jocc1), rtol=0,
                               atol=1e-5)
    eng._last_counts[1] = P.HostCopy(torch.tensor(10 ** 9))
    assert eng._bucket(1) == b_default
    with pytest.raises(ValueError, match="odd"):
        P.ReconEngine((16, 33), device="cpu")


def test_query_args_reach_the_query():
    """Per-frame tensors pass through ``query_args`` (the frame hands the
    body's crossing columns and image features this way)."""
    eng = P.ReconEngine((9, 17, 33), budgets=(2048, 4096), device="cpu")

    def query_fn(pts, radius):
        d = torch.linalg.norm(pts, dim=-1, keepdim=True)
        return (radius - d) * 4.0 + 0.5

    occ1, _ = eng(query_fn, query_args=(torch.tensor(0.5),))
    occ2, _ = eng(query_fn, query_args=(torch.tensor(0.75),))
    assert float((occ2 > 0.5).float().mean()) > \
        2.0 * float((occ1 > 0.5).float().mean())


def jsphere(pts):
    return jax.nn.sigmoid((0.6 - jnp.linalg.norm(pts, axis=-1,
                                                 keepdims=True)) * 30.0)


def psphere(pts):
    return torch.sigmoid((0.6 - torch.linalg.norm(pts, dim=-1,
                                                  keepdim=True)) * 30.0)


def _human(pkg):
    if pkg == "jax":
        from icon_tpu.utils.synthetic import clothed_human_occ
        return lambda pts: clothed_human_occ(pts)[..., None]
    from icon_tpu_torch.utils.synthetic import clothed_human_occ
    return lambda pts: clothed_human_occ(pts)[..., None]


@pytest.mark.parametrize("res", [(9, 17, 33), (17, 33, 65)])
@pytest.mark.parametrize("field", ["sphere", "human"])
def test_exact_mode_matches(res, field):
    """Exact mode, 2 conflict rounds, against the JAX engine's on a sphere
    and on ``clothed_human_occ`` (each package's own copy, which differ by
    up to 6e-7): every level's points, overflow, conflicts and residual
    equal, the grid to 1e-6. The last level is evaluated too. A conflict
    compares the interpolation with the balance, so the upsample must round
    as the JAX package's does (an interpolation of exactly 0.5)."""
    jf, pf = (jsphere, psphere) if field == "sphere" else \
        (_human("jax"), _human("torch"))
    jocc, jstats = J.ReconEngine(res, exact=True, conflict_rounds=2)(jf)
    eng = P.ReconEngine(res, exact=True, conflict_rounds=2, device="cpu")
    assert not eng.faster
    occ, stats = eng(pf)
    assert set(stats) == set(jstats) - {"coarse_occ"}
    for k in stats:
        assert int(stats[k]) == int(jstats[k]), k
    assert sum(int(stats[f"level{lv}_conflicts"]) for lv in (1, 2)) > 0
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                               atol=1e-6)


def test_faster_false_and_pad_multiple():
    """``faster=False`` evaluates the last level (its points equal the JAX
    engine's); ``pad_multiple`` 3 rounds the budgets, the auto-budget
    ladder and level 0 to multiples of 3, as the JAX engine does, and moves
    no voxel of the grid."""
    res = (17, 33, 65)
    jocc, jstats = J.ReconEngine(res, faster=False)(jfield)
    occ, stats = P.ReconEngine(res, faster=False, device="cpu")(pfield)
    assert "coarse_occ" not in stats
    assert int(stats["level2_points"]) == int(jstats["level2_points"]) > 0
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                               atol=1e-5)

    full = (33, 65, 129, 257)
    assert P.ReconEngine(full, pad_multiple=3, device="cpu").budgets == \
        J.ReconEngine(full, pad_multiple=3).budgets
    sizes = []

    def counted(pts):
        sizes.append(pts.shape[1])
        return pfield(pts)
    eng = P.ReconEngine(res, pad_multiple=3, auto_budget=True, device="cpu")
    jeng = J.ReconEngine(res, pad_multiple=3, auto_budget=True)
    occ3, _ = eng(counted)
    jeng(jfield)
    assert eng._bucket(1) == jeng._bucket(1) and eng._bucket(1) % 3 == 0
    assert all(n % 3 == 0 for n in sizes) and sizes[0] == 17 ** 3 + 1
    occ1, _ = P.ReconEngine(res, device="cpu")(pfield)
    assert torch.equal(occ1, occ3)
