"""The kNN CUDA kernel against its plain PyTorch twin, on the card.

Needs a CUDA card and nvcc, and imports no JAX, so it runs on a machine
without it: ``python -m pytest tests/test_torch_knn_cuda.py --noconftest
-m cuda -q`` (the suite's conftest imports jax). Where no card exists the
tests skip."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import knn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kNN kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(n, v, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-.8, .8, (v, 3)).astype(np.float32)))


@pytest.mark.parametrize("n,v,k", [(35937, 10242, 2), (4096, 10242, 8),
                                   (1000, 1024, 1), (777, 5, 5)])
def test_kernel_matches_plain(cuda_device, n, v, k):
    """Keys agree to 1e-5 relative (float32 sums in another order), top-1
    indices wherever the first two keys are more than 1e-5 apart."""
    pts, vts = (x.to(cuda_device) for x in _cloud(n, v, n + k))
    before = knn.launches
    idx, key = knn.nearest_vertices_kernel(pts, vts, k)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    idx0, key0 = knn.nearest_vertices_plain(pts, vts, k)
    err = (key - key0).abs() / key0.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    clear = (key0[:, 1] - key0[:, 0]) > 1e-5 if k > 1 else \
        torch.ones(n, dtype=torch.bool, device=cuda_device)
    assert bool((idx[clear, 0] == idx0[clear, 0]).all())
    if v == k:                                # every vertex, each once
        assert bool((idx.sort(1).values ==
                     torch.arange(k, device=cuda_device)).all())


def test_exact_ties_go_to_the_lowest_index(cuda_device):
    vts = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0],
                        [0, 0, 3.0]], device=cuda_device)
    pts = torch.zeros((64, 3), device=cuda_device)
    idx, _ = knn.nearest_vertices_kernel(pts, vts, 3)
    idx0, _ = knn.nearest_vertices_plain(pts, vts, 3)
    assert idx.tolist() == [[0, 1, 2]] * 64 == idx0.tolist()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    pts, vts = (x.to(cuda_device) for x in _cloud(100, 50, 0))
    with pytest.raises(TypeError, match="float32"):
        knn.nearest_vertices_kernel(pts.double(), vts, 2)
    with pytest.raises(ValueError, match="contiguous"):
        knn.nearest_vertices_kernel(pts.t().contiguous().t(), vts, 2)
    with pytest.raises(ValueError, match="cannot give"):
        knn.nearest_vertices_kernel(pts, vts[:1], 2)
    with pytest.raises(ValueError, match="points on"):
        knn.nearest_vertices_kernel(pts.cpu(), vts, 2)
