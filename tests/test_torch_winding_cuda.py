"""The fast-winding CUDA kernel against its plain PyTorch twin, on the card.

Both read the same cluster table and round every dipole, gap and solid
angle as their own operations in the same order, so they pick the same
clusters; only the order of the sums over the clusters and the faces
differs: the winding numbers agree to 1e-5 absolute, and the signs (w >
0.5) are identical wherever |w - 0.5| > 1e-4. The kernel runs a warp per
point, so the cases cover the shapes where its lanes split unevenly: M
not a multiple of 32 and M = 2,560, K below 32 and K = 1,024, m = 1, N =
0 and 1, and exactly tied gaps (``test_torch_winding_select.mirror_box``).

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_winding_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import winding as kw
from icon_tpu_torch.ops import sdf_fast as sf
from icon_tpu_torch.utils.synthetic import icosphere, synthetic_body
from test_torch_winding_select import mirror_box, mirror_points

pytestmark = pytest.mark.cuda

W_ATOL = 1e-5
SIGN_MARGIN = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the winding kernel has no CPU mode")
    return torch.device("cuda")


def _points(verts, n, seed):
    """Half near the surface (within ~3 cm), half in the body's box."""
    rng = np.random.RandomState(seed)
    near = verts[rng.randint(0, len(verts), n // 2)] + \
        rng.normal(scale=0.03, size=(n // 2, 3))
    box = rng.uniform(verts.min(0) - 0.1, verts.max(0) + 0.1,
                      (n - n // 2, 3))
    return np.concatenate([near, box]).astype(np.float32)


def _agree(points, verts, faces, n_clusters, m, dev):
    cf, cm = sf.build_winding_clusters(verts, faces, n_clusters)
    t = {k: torch.as_tensor(v, device=dev) for k, v in
         (("p", points), ("v", verts), ("f", faces.astype(np.int64)),
          ("cf", cf), ("cm", cm))}
    table, ctri, mask = kw.cluster_table(t["v"], t["f"], t["cf"], t["cm"])
    m = min(m, mask.shape[0])
    before = kw.launches
    got = kw.fast_winding_kernel(t["p"], table, ctri.contiguous(), mask, m)
    want = kw.fast_winding_plain(t["p"], table, ctri, mask, m)
    torch.cuda.synchronize()
    assert kw.launches == before + (len(points) > 0)
    assert got.shape == want.shape == (len(points),)
    if not len(points):
        return got, want
    assert float((got - want).abs().max()) <= W_ATOL
    clear = (want - 0.5).abs() > SIGN_MARGIN
    assert bool(((got > 0.5) == (want > 0.5))[clear].all())
    return got, want


@pytest.mark.parametrize("subdiv,n", [(5, 20000), (3, 5000)])
def test_kernel_matches_plain_on_the_body(cuda_device, subdiv, n):
    v, f = synthetic_body(subdiv=subdiv)
    got, want = _agree(_points(v, n, subdiv), v, f, 256, 16, cuda_device)
    inside = (want > 0.5).float().mean()
    assert 0.05 < float(inside) < 0.95


def test_lattice_points_and_wrapper(cuda_device):
    """The engine's level-0 lattice (33^3) through ``ops.sdf_fast
    .fast_winding`` on the card against the same call on the CPU's plain
    version (the CPU's atan2 rounds otherwise: signs compared away from
    0.5)."""
    v, f = synthetic_body(subdiv=4)
    g = np.linspace(-1.0, 1.0, 33, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cf, cm = sf.build_winding_clusters(v, f)
    args = [pts, v, f.astype(np.int64), cf, cm]
    card = sf.fast_winding(*(torch.as_tensor(a, device=cuda_device)
                             for a in args))
    cpu = sf.fast_winding(*(torch.as_tensor(a) for a in args))
    clear = (cpu - 0.5).abs() > 1e-3
    assert bool(((card.cpu() > 0.5) == (cpu > 0.5))[clear].all())
    assert float((card.cpu() - cpu).abs().max()) < 1e-3


@pytest.mark.parametrize("n_clusters,m", [(1, 1), (8, 16), (16, 16),
                                          (64, 5)])
def test_few_clusters_and_masked_slots(cuda_device, n_clusters, m):
    """K below the 16 near slots (m = K; K = 1 with all 313 faces in one
    cluster), and F not a multiple of K (the padded slots masked out; M =
    40, 20, 5: not multiples of a warp)."""
    v, f = icosphere(subdiv=2, radius=0.6)
    f = f[:-7]                                   # 313 faces: ragged
    _agree(_points(v.astype(np.float32), 3000, 1), v.astype(np.float32), f,
           n_clusters, m, cuda_device)


@pytest.mark.parametrize("n_clusters,m", [(1024, 16), (8, 8), (256, 1)])
def test_cluster_extremes(cuda_device, n_clusters, m):
    """On the 20,480-face body: K = 1,024 (32 keys a lane, M = 20), K = 8
    (M = 2,560 faces a cluster, a lane's 640 pairs) and m = 1."""
    v, f = synthetic_body(subdiv=5)
    _agree(_points(v, 6000, n_clusters), v, f, n_clusters, m, cuda_device)


@pytest.mark.parametrize("n", [0, 1])
def test_no_point_and_one_point(cuda_device, n):
    """N = 0 launches nothing and returns an empty [0]; N = 1 is one warp
    of a block of eight."""
    v, f = synthetic_body(subdiv=3)
    _agree(_points(v, 2, 3)[:n], v, f, 256, 16, cuda_device)


@pytest.mark.parametrize("m", [1, 3])
def test_tied_gaps_pick_the_lower_index(cuda_device, m):
    """Points on the mirror plane of the mirror box see each cluster and
    its mirror at exactly equal gaps (the table made on the CPU, where
    tests/test_torch_winding_select.py pins the ties), at shuffled ids (a
    pair in one lane or in two); plain picks the lower id, and picking the
    other moves w by up to ~0.5, so the kernel's w within 1e-5 of plain's
    means it picked the same."""
    v, f, cf, cm, _ = mirror_box()
    table, ctri, mask = (t.to(cuda_device) for t in kw.cluster_table(
        *(torch.as_tensor(a) for a in (v, f, cf, cm))))
    p = torch.as_tensor(mirror_points(4096), device=cuda_device)
    got = kw.fast_winding_kernel(p, table, ctri.contiguous(), mask, m)
    want = kw.fast_winding_plain(p, table, ctri, mask, m)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= W_ATOL


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    v, f = icosphere(subdiv=1)
    cf, cm = sf.build_winding_clusters(v, f, 8)
    t = [torch.as_tensor(x, device=cuda_device) for x in
         (v.astype(np.float32), f.astype(np.int64), cf, cm)]
    table, ctri, mask = kw.cluster_table(*t)
    p = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        kw.fast_winding_kernel(p, table, ctri, mask, 9)       # m > K
    with pytest.raises(TypeError):
        kw.fast_winding_kernel(p.double(), table, ctri, mask, 4)
