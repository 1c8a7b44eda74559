"""Port parity, the benchmark evaluation: icon_tpu_torch's evaluator
(``eval/evaluator.py``) and test loop (``eval/test_loop.py``) against the
JAX package, on the JAX package's fixture (2 subjects, 2 views, 32^2)
written once for the module.

Tolerances: the surface samples, the occupancy metrics and ``world_to_ndc``
identical; chamfer and P2S on the same meshes to 1e-5 relative (exact
distances, float32 sums in another order); normal consistency to 1e-4
relative (the same rasterized faces, normals interpolated in float32); the
whole loop on one item with converted weights: the two reconstructions
within a quarter voxel of each other (their chamfer distance), and the
metrics to 5e-2 relative. The engine's occupancy moves where the body
features of a query jump between tied faces (the JAX package's engine runs
jitted, Queue C "the body features jump"), which moves the marched surface
by a fraction of a voxel at res 32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import port_cfg

SIZE, VIEWS = 32, 2


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from icon_tpu.data.fixture import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp("jax_fixture"))
    make_synthetic_dataset(root, n_subjects=2, n_views=VIEWS, size=SIZE,
                           vis_res=128)
    return root


def _cfg(root):
    from icon_tpu.data.fixture import fixture_config
    return fixture_config(root, n_views=VIEWS, num_sample_geo=128,
                          image_size=SIZE).replace(mcube_res=32)


def _meshes(root):
    """The test split's scan in calib space and a bumped copy of it."""
    from icon_tpu.data.datasets import PIFuDataset, projection_np
    item = PIFuDataset(_cfg(root), split="test")[0]
    gt = projection_np(item["verts"], item["calib"]).astype(np.float32)
    bump = 0.02 * np.sin(7 * gt[:, :1]) * np.cos(5 * gt[:, 1:2])
    return gt, gt + bump.astype(np.float32), item["faces"], item


def test_host_helpers_identical(fixture_root):
    from icon_tpu.eval import evaluator as JE
    from icon_tpu.eval.test_loop import world_to_ndc as jw
    from icon_tpu_torch.eval import evaluator as PE
    from icon_tpu_torch.eval.test_loop import world_to_ndc as pw
    gt, pred, faces, item = _meshes(fixture_root)
    np.testing.assert_array_equal(PE.sample_surface(pred, faces, 500),
                                  JE.sample_surface(pred, faces, 500))
    np.testing.assert_array_equal(pw(pred, item["calib"]),
                                  jw(pred, item["calib"]))
    rng = np.random.RandomState(0)
    p, lab = rng.rand(300), rng.rand(300)
    assert PE.occupancy_metrics(p, lab) == JE.occupancy_metrics(
        jnp.asarray(p), jnp.asarray(lab))


def test_evaluator_metrics_match(fixture_root):
    """chamfer, P2S and normal consistency of one prediction against the
    scan, on the CPU."""
    from icon_tpu.eval import evaluator as JE
    from icon_tpu_torch.eval import evaluator as PE
    gt, pred, faces, _ = _meshes(fixture_root)
    ref = JE.chamfer_p2s(pred, faces, gt, faces, num_samples=1000)
    got = PE.chamfer_p2s(pred, faces, gt, faces, num_samples=1000,
                         device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert 0.1 < got[0] < 5.0
    flip = np.array([1, -1, -1], np.float32)
    ref = JE.normal_consistency(pred * flip, faces, gt * flip, faces,
                                size=64)
    got = PE.normal_consistency(pred * flip, faces, gt * flip, faces,
                                size=64, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got > 0.0


def test_run_evaluation_matches(fixture_root, capsys):
    """The whole loop on the first test view: the JAX package's
    ``run_evaluation`` and the port's with converted weights."""
    from icon_tpu.data.datasets import PIFuDataset as JD
    from icon_tpu.eval.test_loop import run_evaluation as jrun
    from icon_tpu.models.hgpifu import HGPIFuNet as JNet
    from icon_tpu_torch.data.datasets import PIFuDataset as PD
    from icon_tpu_torch.eval.test_loop import run_evaluation
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    from torch_port_helpers import _randomize
    cfg = _cfg(fixture_root)
    jd = JD(cfg, split="test")
    item = jd[0]
    example = {k: jnp.asarray(v) if k in ("smpl_faces", "smpl_vf_table")
               else jnp.asarray(v)[None] for k, v in item.items()
               if isinstance(v, np.ndarray)}
    jnet = JNet(cfg)
    variables = jax.jit(lambda k, b: jnet.init(k, b, train=False))(
        jax.random.PRNGKey(0), example)
    variables = {k: _randomize(v, np.random.RandomState(3))
                 for k, v in jax.device_get(variables).items()}
    ref = jrun(cfg, jd, jnet, variables, max_items=1, nc_size=64)
    net = HGPIFuNet(port_cfg(cfg), normal_net=False)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for
                         k, v in state_dict_from_flax(
                             variables["params"],
                             variables["batch_stats"]).items()})
    records = []
    got = run_evaluation(port_cfg(cfg), PD(port_cfg(cfg), split="test"),
                         net, max_items=1, nc_size=64, device="cpu",
                         records=records)
    assert set(got) == set(ref) and len(records) == 1
    for name, row in ref.items():
        for k, v in row.items():
            np.testing.assert_allclose(got[name][k], v, rtol=5e-2, err_msg=k)
            assert np.isfinite(got[name][k])
    assert records[0]["n_tris"] > 100
    assert "benchmark" in capsys.readouterr().out

    # the two reconstructions of the item, in the engine's world
    from icon_tpu.eval.test_loop import recon_one as jrecon
    from icon_tpu.recon.engine import ReconEngine as JEngine
    from icon_tpu.recon.engine import reconstruction_resolutions
    from icon_tpu_torch.eval.evaluator import chamfer_p2s
    from icon_tpu_torch.eval.test_loop import recon_one
    from icon_tpu_torch.recon.engine import ReconEngine
    res = reconstruction_resolutions(32)
    jv, jf, _ = jrecon(jnet, variables, item, JEngine(res))
    pv, pf, _ = recon_one(net, PD(port_cfg(cfg), split="test")[0],
                          ReconEngine(res, device="cpu"), device="cpu")
    apart = chamfer_p2s(pv, pf, np.asarray(jv), np.asarray(jf),
                        device="cpu")[0]
    assert apart < 100.0 * 0.25 * 2.0 / 32, apart
