"""The fast-winding kernel's helpers and selection rule, on the CPU.

``csrc/winding.cu`` runs a warp per point: lane l holds clusters l, l + 32,
..., keys each by the order-preserving uint32 image of its gap above its
index, and m rounds of a warp-wide minimum pop the m nearest, the lane that
held each pick rescanning its own keys for the smallest above it. The
selection is emulated here in numpy, bit for bit, and held to
``kernels/winding.py:_order_keys`` under ``torch.topk`` (the plain
version's rule, ties to the lower index as the JAX package's ``lax.top_k``
of -gap). The kernel reads the triangles from ``face_tiles``; the
mirror box (``mirror_box``) gives the card's tie test exactly tied gaps
whose two clusters' terms differ. Imports no JAX.
"""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import winding as kw
from icon_tpu_torch.ops.sdf_fast import build_winding_clusters

NO_KEY = (1 << 64) - 1


def warp_select(gap: np.ndarray, m: int) -> list:
    """csrc/winding.cu's m picks from one point's ``gap [K]`` float32."""
    bits = gap.astype(np.float32).view(np.uint32).astype(np.uint64)
    image = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF,
                     bits | 0x80000000)
    keys = [int(b) << 32 | k for k, b in enumerate(image)]
    lanes = [keys[lane::32] for lane in range(32)]
    cur = [min(ks, default=NO_KEY) for ks in lanes]
    picks = []
    for _ in range(m):
        best = min(cur)                    # the xor-shuffle minimum
        picks.append(best & 0xFFFFFFFF)
        lane = cur.index(best)
        cur[lane] = min((k for k in lanes[lane] if k > best), default=NO_KEY)
    return picks


def _gaps(rng, K: int) -> np.ndarray:
    """Gaps with many exact ties: a few distinct values, both zeros, both
    signs, the infinities, and some random ones."""
    pool = np.array([0.0, -0.0, 0.25, -0.25, 1e-30, -1e-30, 3.5, np.inf,
                     -np.inf, 0.125], np.float32)
    g = pool[rng.randint(0, len(pool), K)]
    free = rng.rand(K) < 0.3
    g[free] = rng.normal(size=int(free.sum())).astype(np.float32)
    return g


@pytest.mark.parametrize("K", [1, 5, 31, 32, 33, 64, 256, 1000, 1024])
def test_warp_selection_matches_order_keys(K):
    rng = np.random.RandomState(K)
    gaps = np.stack([_gaps(rng, K) for _ in range(24)])
    for m in sorted({1, min(2, K), min(3, K), min(16, K)}):
        want = torch.topk(kw._order_keys(torch.from_numpy(gaps)), m, dim=1,
                          largest=False, sorted=True).values & 0xFFFFFFFF
        got = [warp_select(g, m) for g in gaps]
        assert got == want.tolist()


@pytest.mark.parametrize("M", [1, 13, 32, 80])
def test_face_tiles_hold_ctri_and_mask(M):
    rng = np.random.RandomState(M)
    ctri = torch.from_numpy(rng.normal(size=(7, M, 9)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(7, M) < 0.7)
    tiles = kw.face_tiles(ctri, mask)
    T = -(-M // 32)
    assert tiles.shape == (7, T, 10, 32) and tiles.is_contiguous()
    slots = tiles.transpose(2, 3).reshape(7, 32 * T, 10)
    assert torch.equal(slots[:, :M, :9], ctri)
    assert torch.equal(slots[:, :M, 9], mask.float())
    assert not slots[:, M:].any()
    k, f, c = 6, M - 1, 8
    assert tiles[k, f // 32, c, f % 32] == ctri[k, f, c]


def mirror_box(n: int = 8, n_clusters: int = 64, seed: int = 0):
    """A box [-1, 1]^3 cut into an n x n grid a side, whose right half (x
    >= 0) is its left half mirrored with the same corner order (so turned
    inside out), with clusters that pair each left cluster with its mirror
    at shuffled indices: (verts [V, 3], faces [F, 3], cluster_faces [K, M],
    cluster_mask [K, M], pairs [K/2, 2] (left, right) cluster ids).

    The corners are multiples of 2/n, so each cluster's centroid and
    radius equal its mirror's exactly and a point on x = 0 sees the two at
    exactly equal gaps; their exact terms there differ in sign, so a pick
    of the higher index of a tied pair moves w."""
    g = n + 1
    idx = np.arange(g ** 3).reshape(g, g, g)
    c = np.arange(g, dtype=np.float32) * np.float32(2.0 / n) - 1.0
    verts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    left = []
    for a, (b, d) in enumerate(((1, 2), (2, 0), (0, 1))):
        for s in (0, n):
            for i in range(n):
                for j in range(n):
                    q = []
                    for di, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
                        p = [0, 0, 0]
                        p[a], p[b], p[d] = s, i + di, j + dj
                        q.append(idx[tuple(p)])
                    tris = [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
                    if s == 0:
                        tris = [t[::-1] for t in tris]
                    for t in tris:
                        if all(verts[v, 0] <= 0 for v in t):
                            left.append(t)
    left = np.asarray(left, np.int64)
    ix, iy, iz = np.unravel_index(left, (g, g, g))
    right = idx[n - ix, iy, iz]
    faces = np.concatenate([left, right])
    cf_l, cm_l = build_winding_clusters(verts, left, n_clusters // 2)
    K = 2 * len(cf_l)
    ids = np.random.RandomState(seed).permutation(K)
    cf = np.zeros((K, cf_l.shape[1]), np.int32)
    cm = np.zeros((K, cf_l.shape[1]), bool)
    cf[ids[:K // 2]], cm[ids[:K // 2]] = cf_l, cm_l
    cf[ids[K // 2:]], cm[ids[K // 2:]] = cf_l + len(left), cm_l
    return verts, faces, cf, cm, np.stack([ids[:K // 2], ids[K // 2:]], 1)


def mirror_points(n_pts: int, seed: int = 1) -> np.ndarray:
    """Points on x = 0 (y, z in the box and around its faces)."""
    rng = np.random.RandomState(seed)
    yz = rng.uniform(-1.3, 1.3, (n_pts, 2))
    return np.concatenate([np.zeros((n_pts, 1)), yz], 1).astype(np.float32)


@pytest.mark.parametrize("m", [1, 3])
def test_mirror_box_ties_are_exact_and_decide_w(m):
    """The mirror box's pairs have equal centroids' |x|, y, z and radii, so
    points on x = 0 tie; swapping each pair's ids (the other one of a tie
    picked) moves the plain w by far more than the kernel's 1e-5."""
    v, f, cf, cm, pairs = mirror_box()
    t = [torch.as_tensor(a) for a in (v, f, cf, cm)]
    table, ctri, mask = kw.cluster_table(*t)
    lt, rt = table[pairs[:, 0]], table[pairs[:, 1]]
    assert torch.equal(lt[:, 0], -rt[:, 0])
    assert torch.equal(lt[:, 1:4], rt[:, 1:4])
    p = torch.as_tensor(mirror_points(512))
    w = kw.fast_winding_plain(p, table, ctri, mask, m)
    swap = torch.arange(len(table))
    swap[pairs[:, 0]], swap[pairs[:, 1]] = (torch.as_tensor(pairs[:, 1]),
                                            torch.as_tensor(pairs[:, 0]))
    w_swapped = kw.fast_winding_plain(p, table[swap], ctri[swap],
                                      mask[swap], m)
    moved = (w - w_swapped).abs()
    assert float(moved.max()) > 1e-3
    assert float((moved > 1e-5).float().mean()) > 0.5
