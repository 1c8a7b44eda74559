"""Port parity, the body features of kernels/bodyfeat.py: the plain twin,
through icon_tpu_torch.ops.sdf_fast.point_body_features, against
icon_tpu.ops.sdf_fast.point_body_features on the subdiv-3 synthetic body,
for each of the five signs (crossing columns at 65^2, known, ray bins,
winding clusters, none), on lattice and near-surface points, and on the
mirror-symmetric body's level-0 lattice, where candidates tie exactly.
The card kernel's own steps, in plain form: its per-face records against
the terms candidate_distances computes from the corners, the distances
from records against candidate_distances, bit for bit, and its lane-group
pick (emulated in numpy) against torch.argmin.

Signs and vis identical; sdf, normal and cmap within 1e-5 absolute (the
bar of tests/test_torch_sdf_fast.py); the winning face identical to the
JAX package's pick wherever that pick is tie-free: a float64 oracle over
the JAX package's own candidates (its kNN, the vertex-face table) puts the
nearest face 1e-4 relative ahead of the next. The winding-cluster sign is
compared where |w - 0.5| > 1e-4 and the pseudo-normal sign where the pick
is tie-free, as tests/test_torch_winding.py does."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import body, lattice_columns, t

from icon_tpu.ops import sdf_fast as J
from icon_tpu_torch.kernels import bodyfeat as kb
from icon_tpu_torch.kernels.knn import nearest_vertices_kernel
from icon_tpu_torch.ops import sdf_fast as P
from icon_tpu_torch.ops.mesh import vertex_normals

ATOL = 1e-5
SIGN_MARGIN = 1e-4
CLEAR_GAP = 1e-4          # relative gap of a tie-free pick
RES = 65


def _tri_d2(p, a, b, c):
    """Exact squared point-triangle distances in float64: p [N, 3], the
    corners [N, C, 3]."""
    p = p[:, None]
    ab, ac, ap = b - a, c - a, p - a
    n = np.cross(ab, ac)
    nn = np.maximum((n * n).sum(-1), 1e-300)
    bc = np.cross(ab, ap)
    w2 = (bc * n).sum(-1) / nn
    w1 = (np.cross(ap, ac) * n).sum(-1) / nn
    w0 = 1.0 - w1 - w2
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    d_in = ((ap * n).sum(-1)) ** 2 / nn

    def seg(s0, s1):
        e = s1 - s0
        tt = np.clip(((p - s0) * e).sum(-1) / np.maximum((e * e).sum(-1),
                                                         1e-300), 0, 1)
        q = s0 + tt[..., None] * e
        return ((p - q) ** 2).sum(-1)

    d_edge = np.minimum(np.minimum(seg(a, b), seg(b, c)), seg(c, a))
    return np.where(inside, d_in, d_edge)


def _jax_pick(pts, v, f, table, k=2):
    """(face, clear): the nearest of the JAX package's candidate faces in
    float64 and whether it is CLEAR_GAP ahead of every other face."""
    nn = np.asarray(J._nearest_vertices(jnp.asarray(pts), jnp.asarray(v),
                                        k=k))
    cand = table[nn].reshape(len(pts), -1)
    tri = v.astype(np.float64)[f[cand]]                   # [N, C, 3, 3]
    d = _tri_d2(pts.astype(np.float64), tri[..., 0, :], tri[..., 1, :],
                tri[..., 2, :])
    best = cand[np.arange(len(pts)), d.argmin(1)]
    d_best = d.min(1)
    other = np.where(cand == best[:, None], np.inf, d).min(1)
    clear = other - d_best > CLEAR_GAP * d_best + 1e-12
    return best, clear


def _points(v, where, seed):
    rng = np.random.RandomState(seed)
    if where == "lattice":
        g = np.linspace(-1, 1, RES, dtype=np.float32)
        ijk = rng.randint(0, RES, (1500, 3))
        return np.stack([g[ijk[:, 0]], -g[ijk[:, 1]], g[ijk[:, 2]]], -1)
    return (v[rng.randint(0, len(v), 1000)] +
            0.02 * rng.randn(1000, 3)).astype(np.float32)


def _sign_inputs(sign, v, f, pts):
    """(JAX kwargs, port kwargs, the points whose sign is compared)."""
    every = np.ones(len(pts), bool)
    if sign == "columns":
        cb, cm, tids, col_x, col_y, meta = lattice_columns(v, f, RES)
        jcz, _ = jax.jit(J.build_crossing_columns_blocked)(
            jnp.asarray(v), jnp.asarray(f), jnp.asarray(cb),
            jnp.asarray(cm), jnp.asarray(col_x), jnp.asarray(col_y),
            tile_ids=jnp.asarray(tids))
        cz, _ = P.build_crossing_columns_blocked(
            t(v), t(f, torch.int64), t(cb), t(cm), t(col_x), t(col_y),
            tile_ids=t(tids))
        return ({"cross_z": jcz, "cross_meta": jnp.asarray(meta)},
                {"cross_z": cz, "cross_meta": t(meta)}, every)
    if sign == "known":
        inside = np.random.RandomState(4).rand(len(pts)) > 0.5
        return ({"known_inside": jnp.asarray(inside)},
                {"known_inside": t(inside)}, every)
    if sign == "ray":
        rb, rg = J.build_ray_bins(v, f)
        return ({"ray_bins": jnp.asarray(rb), "ray_grid": jnp.asarray(rg)},
                {"ray_bins": t(rb), "ray_grid": t(rg)}, every)
    if sign == "clusters":
        cf, cm = J.build_winding_clusters(v, f, 64)
        w = np.asarray(J.fast_winding(*(jnp.asarray(x) for x in
                                        (pts, v, f, cf, cm))))
        return ({"cluster_faces": jnp.asarray(cf),
                 "cluster_mask": jnp.asarray(cm)},
                {"cluster_faces": t(cf), "cluster_mask": t(cm)},
                np.abs(w - 0.5) > SIGN_MARGIN)
    return {}, {}, None


def _agree(v, f, cmaps, vis, table, pts, sign):
    """Both packages' point_body_features; the twin's winning face against
    the JAX package's tie-free picks. Returns the tie-free share."""
    jkw, pkw, compared = _sign_inputs(sign, v, f, pts)
    ref = [np.asarray(r) for r in J.point_body_features(
        jnp.asarray(pts), jnp.asarray(v), jnp.asarray(f),
        jnp.asarray(table), jnp.asarray(cmaps), jnp.asarray(vis), **jkw)]
    args = (t(pts), t(v), t(f, torch.int64), t(table, torch.int64),
            t(cmaps), t(vis))
    out = [o.numpy() for o in P.point_body_features(*args, **pkw)]
    pick, clear = _jax_pick(pts, v, f, table)
    if compared is None:                   # the pseudo-normal sign
        compared = clear
    np.testing.assert_array_equal(out[0][compared] > 0,
                                  ref[0][compared] > 0)
    np.testing.assert_allclose(np.abs(out[0]), np.abs(ref[0]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=ATOL)
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out[3], ref[3])

    # the twin, called as ops/sdf_fast.py calls it, and its winning face
    nn, _ = nearest_vertices_kernel(args[0], args[1], 2)
    normals = vertex_normals(args[1][None], args[2])[0]
    sign_kw = {k: x for k, x in pkw.items()
               if k in ("known_inside", "cross_z", "cross_meta")}
    twin = kb.body_features_kernel(args[0], nn, args[1], args[2], args[3],
                                   normals, args[4], args[5], **sign_kw)
    for a, b in zip(twin[1:4], out[1:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    if sign_kw:
        np.testing.assert_array_equal(twin[0].numpy(), out[0])
    else:
        np.testing.assert_array_equal(twin[0].numpy(), np.abs(out[0]))
    best = twin[4].numpy()
    np.testing.assert_array_equal(best[clear], pick[clear])
    return float(clear.mean())


@pytest.mark.parametrize("where", ["lattice", "near"])
@pytest.mark.parametrize("sign", ["columns", "known", "ray", "clusters",
                                  "none"])
def test_point_body_features_matches_jax(sign, where):
    """Most lattice points lie far from the body, where the nearest point
    is a corner shared by several candidates: few picks there are
    tie-free."""
    v, f, cmaps, vis, table = body(subdiv=3)
    pts = _points(v, where, seed=len(sign) + len(where))
    clear = _agree(v, f, cmaps, vis, table, pts, sign)
    assert clear > (0.03 if where == "lattice" else 0.5)


def test_mirror_body_ties_keep_the_first_candidate():
    """The level-0 lattice (33^3) of the mirror-symmetric body: most points
    lie exactly as far from two distinct candidate faces (a far point's
    nearest corner is shared). Both packages keep the first candidate, so
    the features agree on every point."""
    v, f, cmaps, vis, table = body(subdiv=3)
    g = np.linspace(-1, 1, 33, dtype=np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([xx, -yy, zz], -1).reshape(-1, 3)
    tp, tv = t(pts), t(v)
    nn, _ = nearest_vertices_kernel(tp, tv, 2)
    cand = t(table, torch.int64)[nn.long()].reshape(len(pts), -1)
    d2 = kb.candidate_distances(tp, tv[t(f, torch.int64)].reshape(-1, 9)[
        cand])
    at_min = d2 == d2.min(1, keepdim=True).values
    first = cand[torch.arange(len(pts)), at_min.int().argmax(1)]
    tied = int((at_min & (cand != first[:, None])).any(1).sum())
    assert tied > 1000
    _agree(v, f, cmaps, vis, table, pts, "columns")


def test_cpu_route_and_refusals():
    """A CPU tensor takes the plain twin (an empty N included); shapes and
    devices the kernel does not take raise before any launch."""
    v, f, cmaps, vis, table = body(subdiv=1)
    tv, tf, tt = t(v), t(f, torch.int64), t(table, torch.int64)
    normals = vertex_normals(tv[None], tf)[0]
    pts = t(_points(v, "near", 5)[:50])
    nn, _ = nearest_vertices_kernel(pts, tv, 2)
    args = (pts, nn, tv, tf, tt, normals, t(cmaps), t(vis))
    before = kb.launches_bodyfeat
    got = kb.body_features_kernel(*args)
    want = kb.point_body_features_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kb.launches_bodyfeat == before
    empty = kb.body_features_kernel(pts[:0], nn[:0], *args[2:])
    assert [tuple(e.shape) for e in empty] == [(0, 1), (0, 3), (0, 3),
                                               (0, 1), (0,)]
    with pytest.raises(ValueError, match="vis"):
        kb.body_features_kernel(*args[:7], t(vis)[:, 0])
    with pytest.raises(ValueError, match="nn_idx"):
        kb.body_features_kernel(pts, nn[:10], *args[2:])
    with pytest.raises(ValueError, match="go together"):
        kb.body_features_kernel(*args, cross_z=torch.zeros(4, 32))
    with pytest.raises(ValueError, match="known_inside"):
        kb.body_features_kernel(*args, known_inside=torch.ones(3, dtype=bool))
    with pytest.raises(ValueError, match="unsupported device"):
        kb.body_features_kernel(*(a.to("meta") for a in args))


def _corner_terms(v, f):
    """The per-face terms of candidate_distances, spelled as it spells
    them: (corners [F, 9], n2, l01, l12, l20), each [F]."""
    tri = t(v)[t(f, torch.int64)].reshape(-1, 9)
    (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = tri.unbind(-1)
    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    vx, vy, vz = v2x - v0x, v2y - v0y, v2z - v0z
    nx, ny, nz = kb._cross(ux, uy, uz, vx, vy, vz)
    n2 = torch.clamp(kb._dot(nx, ny, nz, nx, ny, nz), min=1e-12)

    def length(ax_, ay_, az_, bx_, by_, bz_):
        ex, ey, ez = bx_ - ax_, by_ - ay_, bz_ - az_
        return torch.clamp(kb._dot(ex, ey, ez, ex, ey, ez), min=1e-12)

    return (tri, n2, length(v0x, v0y, v0z, v1x, v1y, v1z),
            length(v1x, v1y, v1z, v2x, v2y, v2z),
            length(v2x, v2y, v2z, v0x, v0y, v0z))


def test_face_records_hold_the_candidate_terms():
    """The records' plain builder on the subdiv-5 body: the corners and
    every clamped term bit-equal to candidate_distances' own, the corner
    ids' int32 bits in the last three words, 64 bytes a face."""
    v, f, _, _, _ = body(subdiv=5)
    rec = kb.face_records_plain(t(v), t(f, torch.int64))
    assert rec.dtype == torch.float32 and rec.shape == (len(f), 16)
    assert kb.RECORD_WORDS * rec.element_size() == 64
    tri, n2, l01, l12, l20 = _corner_terms(v, f)
    np.testing.assert_array_equal(rec[:, :9].numpy(), tri.numpy())
    for col, want in zip(range(9, 13), (n2, l01, l12, l20)):
        np.testing.assert_array_equal(rec[:, col].numpy(), want.numpy())
    np.testing.assert_array_equal(
        rec[:, 13:].contiguous().view(torch.int32).numpy(), f)


@pytest.mark.parametrize("case", ["subdiv-5 near", "mirror level-0 lattice",
                                  "NaN corners"])
def test_record_distances_match_candidate_distances(case):
    """The kernel's distance from a face record (the edges, u, v and the
    cross recomputed from the stored corners) is candidate_distances' bit
    for bit on each point's k x deg candidates: near the subdiv-5 body,
    on the mirror body's level-0 lattice (33^3, exact ties) and with NaN
    corners (NaN where candidate_distances has NaN)."""
    v, f, _, _, table = body(subdiv=5)
    v = v.copy()
    if case == "mirror level-0 lattice":
        g = np.linspace(-1, 1, 33, dtype=np.float32)
        zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
        pts = np.stack([xx, -yy, zz], -1).reshape(-1, 3)
    else:
        pts = _points(v, "near", seed=11)
    if case == "NaN corners":
        v[np.random.RandomState(12).randint(0, len(v), 200)] = np.nan
    tp, tv, tf = t(pts), t(v), t(f, torch.int64)
    nn, _ = nearest_vertices_kernel(tp, t(np.nan_to_num(v)), 2)
    cand = t(table, torch.int64)[nn.long()].reshape(len(pts), -1)
    want = kb.candidate_distances(tp, tv[tf].reshape(-1, 9)[cand])
    got = kb.record_distances_plain(tp, kb.face_records_plain(tv, tf)[cand])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (np.isnan(want.numpy()).any(1).mean() > 0.01) == \
        (case == "NaN corners")


def _group_pick(d2: np.ndarray) -> np.ndarray:
    """csrc/bodyfeat.cu's pick in numpy: G lanes a point (the power of two
    at or above C, at most 4, kMaxGroup); lane l walks candidates l, l + G,
    ... with
    the strict < (a NaN over a number, the first NaN kept), a lane without
    one holding (+inf, C); then the butterfly of xor shuffles at offsets
    G/2 ... 1, each lane keeping the earlier of its own and its partner's
    (NaN first, the lesser d2, the lower index). Every lane must end with
    the same index, which is returned [N]."""
    n, c = d2.shape
    g = 1
    while g < c and g < 4:
        g *= 2
    best = np.full((n, g), np.inf, np.float32)
    best_j = np.full((n, g), c)
    for lane in range(g):
        for j in range(lane, c, g):
            d, b = d2[:, j], best[:, lane]
            take = (j == lane) | (d < b) | (np.isnan(d) & ~np.isnan(b))
            best[take, lane] = d[take]
            best_j[take, lane] = j
    off = g // 2
    while off:
        partner = np.arange(g) ^ off
        od, oj = best[:, partner], best_j[:, partner]
        on, bn = np.isnan(od), np.isnan(best)
        first = np.where(on != bn, on,
                         np.where(~on & (od != best), od < best, oj < best_j))
        best = np.where(first, od, best)
        best_j = np.where(first, oj, best_j)
        off //= 2
    assert (best_j == best_j[:, :1]).all()
    return best_j[:, 0]


@pytest.mark.parametrize("c", [3, 8, 15, 16, 24, 64])
def test_group_pick_is_argmins(c):
    """The lane-group pick equals torch.argmin's on rows of exact ties
    (few distinct values, +0 against -0, +inf), NaNs (the first NaN wins,
    rows of NaN only), for k x deg = 3, 8, 15, 16, 24 and 64 (G = 4: a
    lane idle, then 2 to 16 candidates a lane, uneven at 15)."""
    rng = np.random.RandomState(c)
    n = 4000
    d2 = rng.randint(0, 4, (n, c)).astype(np.float32) * 0.25
    d2[rng.rand(n, c) < 0.05] = np.nan
    d2[rng.rand(n, c) < 0.05] = np.inf
    zero = rng.rand(n, c) < 0.1
    d2[zero] = np.where(rng.rand(int(zero.sum())) < 0.5, 0.0, -0.0)
    d2[:50] = np.nan
    d2[50:100] = 1.0
    d2[100:150] = rng.rand(50, c)
    got = _group_pick(d2)
    want = torch.argmin(torch.from_numpy(d2), dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    ties = (d2 == np.nanmin(np.where(np.isnan(d2), np.inf, d2), 1,
                            keepdims=True)).sum(1) > 1
    assert ties.mean() > 0.3 and np.isnan(d2).any(1).mean() > 0.1
