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


def _assert_matches_plain(pts, vts, k):
    """Keys within 1e-5 relative of the plain version's and sorted; every
    pick's index equal to the plain version's wherever the plain keys on
    both sides of it (the (k+1)-th included) are more than 1e-5 apart."""
    before = knn.launches
    idx, key = knn.nearest_vertices_kernel(pts, vts, k)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    idx0, key0 = knn.nearest_vertices_plain(pts, vts, k)
    err = (key - key0).abs() / key0.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    # the plain keys in order, one past the last pick (+inf when V = k)
    d2 = knn.squared_norms(vts)[None] - 2.0 * (pts @ vts.T)
    nxt = d2.topk(min(k + 1, vts.shape[0]), 1, largest=False).values
    after = nxt[:, k:k + 1] if vts.shape[0] > k else \
        torch.full_like(key0[:, :1], float("inf"))
    keys = torch.cat([torch.full_like(after, -float("inf")), key0, after], 1)
    gaps = torch.diff(keys, dim=1)
    clear = (gaps[:, :k] > 1e-5) & (gaps[:, 1:] > 1e-5)
    assert bool((idx[clear] == idx0[clear]).all())
    assert float(clear.float().mean()) > 0.5
    return idx, idx0


@pytest.mark.parametrize("v,k", [(v, k) for v in (5, 511, 512, 513, 10242,
                                                  65536)
                                  for k in range(1, 9) if k <= v])
def test_every_pick_on_ragged_shapes(cuda_device, v, k):
    """V across the 512-vertex stages' edges, N = 1,037 (no multiple of a
    block's points), every k."""
    pts, vts = (x.to(cuda_device) for x in _cloud(1037, v, 10 * v + k))
    _assert_matches_plain(pts, vts, k)


@pytest.mark.parametrize("k", [2, 8])
def test_points_far_off_the_body(cuda_device, k):
    """|p| up to 3 against the subdiv-5 body: the margin grows with |p|."""
    from icon_tpu_torch.utils.synthetic import synthetic_body
    rng = np.random.RandomState(k)
    vts = torch.from_numpy(synthetic_body(subdiv=5)[0]).to(cuda_device)
    pts = torch.from_numpy(rng.uniform(-3, 3, (20000, 3)).astype(
        np.float32)).to(cuda_device)
    _assert_matches_plain(pts, vts, k)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_mirror_body_lattice_identical(cuda_device, k):
    """The 33^3 level-0 lattice against the mirror-symmetric subdiv-5 body:
    exact key ties on the symmetry plane go to the lowest index in both,
    so ``idx`` equals the plain version's on every row."""
    from icon_tpu_torch.utils.synthetic import synthetic_body
    vts = torch.from_numpy(synthetic_body(subdiv=5)[0]).to(cuda_device)
    g = torch.linspace(0.0, 1.0, 33, device=cuda_device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    pts = (torch.stack([xx, yy, zz], -1).reshape(-1, 3) *
           torch.tensor([2.0, -2.0, 2.0], device=cuda_device) +
           torch.tensor([-1.0, 1.0, -1.0], device=cuda_device)).contiguous()
    idx, _ = knn.nearest_vertices_kernel(pts, vts, k)
    idx0, _ = knn.nearest_vertices_plain(pts, vts, k)
    assert bool((idx == idx0).all()), int((idx != idx0).any(1).sum())


def test_one_launch_per_call(cuda_device):
    pts, vts = (x.to(cuda_device) for x in _cloud(300, 700, 3))
    before = knn.launches
    for _ in range(3):
        knn.nearest_vertices_kernel(pts, vts, 2)
    knn.nearest_vertices_kernel(pts[:0], vts, 2)     # no points: no launch
    torch.cuda.synchronize()
    assert knn.launches == before + 3
