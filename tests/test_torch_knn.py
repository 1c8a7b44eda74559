"""Port parity, kNN: icon_tpu_torch's exact k-nearest vertices against the
JAX package's exact top_k (ops/sdf_fast.py:_nearest_vertices) and its
bucketed Pallas kernel run in interpret mode (ops/pallas/knn.py). On the CPU
the wrapper runs the plain PyTorch twin; the CUDA kernel itself is checked
on the card by tests/test_torch_knn_cuda.py and chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import t

from icon_tpu.ops.sdf_fast import _nearest_vertices
from icon_tpu_torch.kernels import knn

RNG = np.random.RandomState(5)


def _cloud(n, v):
    pts = RNG.uniform(-1, 1, (n, 3)).astype(np.float32)
    vts = RNG.uniform(-0.8, 0.8, (v, 3)).astype(np.float32)
    return pts, vts


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_plain_matches_exact_top_k(k):
    pts, vts = _cloud(700, 1500)
    ref = np.asarray(_nearest_vertices(jnp.asarray(pts), jnp.asarray(vts),
                                       k=k, approx=False))
    idx, key = knn.nearest_vertices_plain(t(pts), t(vts), k)
    np.testing.assert_array_equal(idx.numpy(), ref)
    # keys: |v|^2 - 2 p.v of the picks, ascending
    d = (vts ** 2).sum(-1)[ref] - 2 * np.einsum("nc,nkc->nk", pts, vts[ref])
    np.testing.assert_allclose(key.numpy(), d, rtol=0, atol=1e-5)
    assert (np.diff(key.numpy(), axis=1) >= 0).all()


def test_against_pallas_bucket_kernel_interpret():
    """The Pallas kernel's top-1 is exact; its k picks are the best of
    per-512-vertex-tile minima, so at V = 1024 (two tiles) its second pick
    differs from exact top-2 where both true neighbours share a tile. Top-1
    must agree everywhere, and where the Pallas picks came from different
    tiles they are the exact pick set."""
    from icon_tpu.ops.pallas.knn import TILE_V, nearest_vertices_pallas
    pts, vts = _cloud(512, 1024)
    ref = np.asarray(nearest_vertices_pallas(jnp.asarray(pts),
                                             jnp.asarray(vts), k=2,
                                             interpret=True))
    idx, _ = knn.nearest_vertices_kernel(t(pts), t(vts), 2)
    idx = idx.numpy()
    np.testing.assert_array_equal(idx[:, 0], ref[:, 0])
    split = idx[:, 0] // TILE_V != idx[:, 1] // TILE_V
    assert split.mean() > 0.3
    np.testing.assert_array_equal(np.sort(idx[split], 1),
                                  np.sort(ref[split], 1))


def test_rejects_bad_input_and_cpu_takes_plain():
    pts, vts = _cloud(16, 3)
    with pytest.raises(ValueError, match="cannot give"):
        knn.nearest_vertices_kernel(t(pts), t(vts), 4)
    with pytest.raises(ValueError, match="cannot give"):
        knn.nearest_vertices_plain(t(pts), t(vts), 4)
    with pytest.raises(ValueError, match="k must be"):
        knn.nearest_vertices_kernel(t(pts), t(vts), 9)
    before = knn.launches
    idx, _ = knn.nearest_vertices_kernel(t(pts), t(vts), 3)
    assert knn.launches == before            # CPU tensors launch nothing
    assert sorted(idx[0].tolist()) == [0, 1, 2]
