"""Port parity, the surface tools: icon_tpu_torch's screened Poisson
reconstruction (``ops/poisson.py``) and the TetraSMPL asset builder
(``apps/tetrahedronize.py``) against the JAX package's, on the CPU.

Tolerances:

- the splat, the divergence and the Laplacian to 1e-6 (the same float32
  operations in the same order); the sample points identical;
- the conjugate gradients on a small screened system to 1e-4 of the
  solution's largest magnitude after 40 iterations, and to 1e-6 relative
  where the residual reaches the tolerance at the first iteration (the
  masked stop: the nine later iterations, whose ``p`` is 0, change
  nothing and make no NaN);
- the reconstructed sphere (``tests/test_pymaf_infer.py``'s, at res 32
  and the default 5 res iterations): vertex and face counts equal, every
  vertex within ``CELL_SHARE`` of a grid cell of the other mesh. CG's
  float32 dot products summed in another order drift the iterates apart
  (a Krylov method amplifies its rounding): ~1% of chi's range, which
  moves the level set by a fraction of a cell;
- the tetrahedralization, the transferred weights and the npz identical
  (the same host numpy and scipy code).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial import cKDTree

CELL_SHARE = 0.5


def test_poisson_stencils_match():
    from icon_tpu.ops import poisson as J
    from icon_tpu_torch.ops import poisson as P
    rng = np.random.RandomState(0)
    x = rng.randn(9, 10, 11).astype(np.float32)
    v = rng.randn(9, 10, 11, 3).astype(np.float32)
    for ax in range(3):
        for d in (-1, 1):
            np.testing.assert_array_equal(
                P._shift(torch.from_numpy(x), ax, d).numpy(),
                np.asarray(J._shift(jnp.asarray(x), ax, d)))
    np.testing.assert_allclose(P._laplace(torch.from_numpy(x)).numpy(),
                               np.asarray(J._laplace(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(P._div(torch.from_numpy(v)).numpy(),
                               np.asarray(J._div(jnp.asarray(v))),
                               rtol=0, atol=1e-6)
    p = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    val = rng.randn(500, 3).astype(np.float32)
    grid = P._splat(torch.from_numpy(p), torch.from_numpy(val), 8)
    np.testing.assert_allclose(
        grid.numpy(), np.asarray(J._splat(jnp.asarray(p), jnp.asarray(val),
                                          8)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        P._sample(grid[..., 0], torch.from_numpy(p)).numpy(),
        np.asarray(J._sample(jnp.asarray(grid[..., 0].numpy()),
                             jnp.asarray(p))), rtol=0, atol=1e-6)
    verts = rng.randn(30, 3).astype(np.float32)
    faces = rng.randint(0, 30, (40, 3))
    for a, b in zip(P.sample_surface(verts, faces, 50.0, seed=4),
                    J.sample_surface(verts, faces, 50.0, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_conjugate_gradient_matches():
    import jax
    from icon_tpu.ops import poisson as J
    from icon_tpu_torch.ops.poisson import _laplace, conjugate_gradient
    rng = np.random.RandomState(1)
    w = rng.uniform(0.5, 1.5, (8, 8, 8)).astype(np.float32)
    b = rng.randn(8, 8, 8).astype(np.float32)
    want, _ = jax.scipy.sparse.linalg.cg(
        lambda x: J._laplace(x) - 4.0 * jnp.asarray(w) * x, jnp.asarray(b),
        x0=jnp.zeros((8, 8, 8)), maxiter=40)
    got = conjugate_gradient(
        lambda x: _laplace(x) - 4.0 * torch.from_numpy(w) * x,
        torch.from_numpy(b), 40)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # converged after one iteration: the later ones leave x as it is
    want, _ = jax.scipy.sparse.linalg.cg(lambda x: 3.0 * x, jnp.asarray(b),
                                         maxiter=10)
    got = conjugate_gradient(lambda x: 3.0 * x, torch.from_numpy(b), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_poisson_reconstruct_matches():
    from icon_tpu.ops.poisson import poisson_reconstruct as jrecon
    from icon_tpu.utils.synthetic import icosphere
    from icon_tpu_torch.ops.poisson import poisson_reconstruct
    v, f = icosphere(3)
    v = (v * 0.6).astype(np.float32)
    res = 32
    wv, wf = jrecon(v, f, res=res)
    gv, gf = poisson_reconstruct(v, f, res=res, device="cpu")
    assert gv.dtype == np.float32 and gf.dtype == np.int64
    assert gv.shape == wv.shape and gf.shape == wf.shape
    cell = float((v.max(0) - v.min(0)).max()) * 1.16 / res
    for a, b in ((gv, wv), (wv, gv)):
        assert cKDTree(a).query(b)[0].max() <= CELL_SHARE * cell
    r = np.linalg.norm(gv, axis=1)
    assert abs(float(r.mean()) - 0.6) < 0.06 and float(r.std()) < 0.05


def test_poisson_export_matches_on_the_same_grid(monkeypatch):
    """poisson_reconstruct's vertices equal the JAX package's in order
    when both march the same grid: the JAX solve's occupancy grid handed
    to the port's export (the port's own solve differs by CG's rounding
    drift, which the nearest-vertex check above bounds) gives the JAX
    mesh, faces identical and vertices to 1e-5."""
    from icon_tpu.ops.poisson import poisson_reconstruct as jrecon
    from icon_tpu.recon import export as JE
    from icon_tpu.utils.synthetic import icosphere
    from icon_tpu_torch.ops.poisson import poisson_reconstruct
    from icon_tpu_torch.recon import export as PE
    v, f = icosphere(3)
    v = (v * 0.6).astype(np.float32)
    grids = []
    j_extract, p_extract = JE.extract_mesh, PE.extract_mesh

    def record(occ, **kw):
        grids.append(np.asarray(occ))
        return j_extract(occ, **kw)

    def replay(occ, **kw):
        assert tuple(occ.shape) == grids[0].shape
        return p_extract(torch.from_numpy(grids[0]), **kw)

    monkeypatch.setattr(JE, "extract_mesh", record)
    wv, wf = jrecon(v, f, res=32)
    monkeypatch.setattr(PE, "extract_mesh", replay)
    gv, gf = poisson_reconstruct(v, f, res=32, device="cpu")
    assert len(wf) > 1000
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def body():
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    return synthetic_smplx_model(subdiv=3)


def test_tetra_cli_matches_and_loads(body, tmp_path):
    """The CLI on a SMPL release pickle of the synthetic SMPL-X body: the
    npz (``tetrahedralize`` and ``transfer_weights`` through
    ``build_tetra_npz``) equal to the JAX CLI's, and read by the port's
    tetra loader (the host functions alone are pinned in
    ``tests/test_torch_copies.py``)."""
    from icon_tpu.apps.tetrahedronize import main as jmain
    from icon_tpu_torch.apps.tetrahedronize import main
    from icon_tpu_torch.models.smplx.tetra import load_tetra_body_model
    from icon_tpu_torch.utils.synthetic import write_smpl_pkl
    pkl = write_smpl_pkl(str(tmp_path / "models" / "SMPL_MALE.pkl"), body)
    out = main(["-models", str(tmp_path / "models"), "-out",
                str(tmp_path / "port")])
    jmain(["-models", str(tmp_path / "models"), "-out",
           str(tmp_path / "jax")])
    assert list(out) == ["male"]
    got, want = np.load(out["male"]), np.load(
        str(tmp_path / "jax" / "tetra_male_adult_smpl.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], k)
    model, extras = load_tetra_body_model(pkl, out["male"])
    n = len(body.v_template)
    added = len(got["v_template_added"])
    assert extras["n_surface"] == n and added > 20
    assert model.v_template.shape == (n + added, 3)
    assert extras["tetrahedrons"].max() < n + added
    np.testing.assert_allclose(model.lbs_weights.sum(1).numpy(), 1.0,
                               atol=1e-5)
    with torch.no_grad():
        verts, _ = model(betas=torch.zeros(1, 10))
    np.testing.assert_allclose(verts[0].numpy(), model.v_template.numpy(),
                               atol=1e-5)
    assert os.path.getsize(out["male"]) > 0
