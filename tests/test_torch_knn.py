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


# -- the kernel's filter margin (csrc/knn.cu's note) --------------------------
# The card's kernel filters by a tensor-core key whose operands are split
# into TF32 parts and rescores in float32 every pair whose filter key lies
# within key_margin of the row's threshold. Here the split is emulated in
# numpy (truncation, and cvt.rna's round to nearest with ties away from
# zero), the three products ah.bl + al.bh + ah.bh are summed exactly in
# float64, and the float32 key follows the kernel's chain; the tensor
# core's own accumulation error is what the margin's slack beyond the
# split's residual covers.

def _tf32(x, mode):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if mode == "rna":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x, mode):
    hi = _tf32(x, mode)
    return hi.astype(np.float64), _tf32(x - hi, mode).astype(np.float64)


def _keys(pts, vts, mode):
    """(filter key, float32 key) [N, V] as the kernel forms them."""
    p = pts.astype(np.float32)
    w = knn.squared_norms(t(vts)).numpy()
    b = np.concatenate([-2.0 * vts.astype(np.float32), w[:, None]], 1)
    a = np.concatenate([p, np.ones((len(p), 1), np.float32)], 1)
    (ah, al), (bh, bl) = _split(a, mode), _split(b, mode)
    k_tc = ah @ bl.T + al @ bh.T + ah @ bh.T
    # float32 products and fmas: the float64 product of two float32 values
    # is exact, so one float64 step rounded to float32 is the fma
    p64, b64 = p.astype(np.float64), b.astype(np.float64)
    s = (p64[:, None, 0] * b64[None, :, 0]).astype(np.float32)
    s = (p64[:, None, 1] * b64[None, :, 1] + s).astype(np.float32)
    s = (p64[:, None, 2] * b64[None, :, 2] + s).astype(np.float32)
    key = (b64[None, :, 3] + s).astype(np.float32)
    return k_tc, key


def _check_margin(pts, vts, mode, k=2, chunk=512):
    """Every pair's TF32 key within key_margin of its float32 key; the
    plain version's top-k pass the filter against the row's k-th key; the
    kernel's per-row bound covers key_margin. Returns the largest share of
    the margin used."""
    vt = t(vts)
    idx, _ = knn.nearest_vertices_plain(t(pts), vt, k)
    idx = idx.numpy()
    sq = vts.astype(np.float64) ** 2
    W = sq.sum(1).max() * (1 + 2 ** -20)       # the kernel's rounded-up max
    used = 0.0
    for i0 in range(0, len(pts), chunk):
        p = pts[i0:i0 + chunk]
        k_tc, key = _keys(p, vts, mode)
        m = knn.key_margin(t(p), vt).numpy()
        err = np.abs(k_tc - key.astype(np.float64))
        assert (err <= m).all(), float((err / m).max())
        used = max(used, float((err / m).max()))
        rows = np.arange(len(p))[:, None]
        picks = idx[i0:i0 + chunk]
        thr = key[rows, picks].max(1, keepdims=True).astype(np.float64)
        assert (k_tc[rows, picks] <= thr + m[rows, picks]).all()
        norm = np.sqrt((p.astype(np.float64) ** 2).sum(1))
        row = knn.MARGIN_C * (2 * norm * np.sqrt(W) + W) + knn.MARGIN_ABS
        assert (m <= row[:, None]).all()
    return used


@pytest.mark.parametrize("mode", ["trunc", "rna"])
def test_margin_on_the_level0_lattice_and_the_body(mode):
    """The 33^3 level-0 lattice against the subdiv-5 synthetic body (10,242
    vertices), as the frame's first kNN call sees them."""
    from icon_tpu_torch.utils.synthetic import synthetic_body
    vts, _ = synthetic_body(subdiv=5)
    g = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    pts = (np.stack([xx, yy, zz], -1).reshape(-1, 3) *
           np.float32([2, -2, 2]) + np.float32([-1, 1, -1])).astype(
               np.float32)
    _check_margin(pts, vts.astype(np.float32), mode)


@pytest.mark.parametrize("mode", ["trunc", "rna"])
def test_margin_on_drawn_points(mode):
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra.numpy import arrays

    coords = st.floats(-3, 3, width=32, allow_subnormal=True)

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(arrays(np.float32, st.tuples(st.integers(1, 40), st.just(3)),
                  elements=coords),
           arrays(np.float32, st.tuples(st.integers(8, 200), st.just(3)),
                  elements=st.floats(-1, 1, width=32)))
    def check(pts, vts):
        _check_margin(pts, vts, mode, k=min(8, len(vts)))

    check()
