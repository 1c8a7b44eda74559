"""The body-feature CUDA kernel against its plain PyTorch twin, on the card.

The kernel rounds every operation as the plain version's tensor operations
do on the card, so the two agree bit for bit: best_face, sign and vis
identical on every point, sdf, normal and cmap equal. The cases: the
level-0 lattice of the mirror-symmetric body (exact ties between
candidates), near-surface points with known signs, the cube without a
sign, an int32 table, an empty N, the wrapper's refusals, two host
threads on one stream; NaN corners, k x deg from 1 to 64, powers of two
or not (groups of 1, 2 and 4 lanes, idle lanes, up to 16 candidates a
lane), N = 1, 17 and 33 (groups past the end), the face records built
per call against once a body and against their plain builder, and a call
captured in a CUDA graph and replayed.

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_bodyfeat_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import sys
import threading

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import bodyfeat as kb
from icon_tpu_torch.kernels.knn import nearest_vertices_kernel
from icon_tpu_torch.ops import sdf_fast as sf
from icon_tpu_torch.ops.mesh import vertex_normals
from icon_tpu_torch.utils.synthetic import synthetic_body

pytestmark = pytest.mark.cuda

RES = 65                                  # the column lattice's side


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the body-feature kernel has no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _body(dev, subdiv=5, table_dtype=torch.int64):
    """The mirror-symmetric synthetic body's kernel inputs on ``dev``:
    (verts, faces, table, normals, cmaps, vis, cross_z, cross_meta)."""
    v, f = synthetic_body(subdiv=subdiv)
    cmaps = ((v - v.min(0)) / (v.max(0) - v.min(0))).astype(np.float32)
    vis = (v[:, 2:3] > 0).astype(np.float32)
    col_x = np.linspace(-1.0, 1.0, RES, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, RES, dtype=np.float32)
    cb, cm, tids = sf.build_column_bins(v, f, col_x, col_y, compact=True)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    verts, faces = t(v), t(f, torch.int64)
    cross_z, _ = sf.build_crossing_columns_blocked(
        verts, faces, t(cb), t(cm), t(col_x), t(col_y), t(tids))
    h = (RES - 1) / 2.0
    meta = t([-1.0, 1.0, h, -h, float(RES), float(RES)], torch.float32)
    table = t(sf.build_vertex_face_table(f, len(v)), table_dtype)
    normals = vertex_normals(verts[None], faces)[0]
    return (verts, faces, table, normals, t(cmaps), t(vis),
            cross_z.contiguous(), meta)


def _lattice(n, dev):
    g = torch.linspace(-1.0, 1.0, n, device=dev)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([xx, -yy, zz], -1).reshape(-1, 3).contiguous()


def _near(verts, n, seed):
    rng = np.random.RandomState(seed)
    v = verts.cpu().numpy()
    p = v[rng.randint(0, len(v), n)] + 0.02 * rng.randn(n, 3)
    return torch.from_numpy(p.astype(np.float32)).to(verts.device)


def _assert_same(got, want, nan=False):
    """Outputs of the kernel and the plain twin: every tensor equal (with
    ``nan``, a NaN equal to a NaN)."""
    names = ("sdf", "normal", "cmap", "vis", "best_face")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        diff = g != w
        if nan and g.is_floating_point():
            diff &= ~(torch.isnan(g) & torch.isnan(w))
        bad = int(diff.reshape(len(g), -1).any(1).sum()) if len(g) \
            else 0
        assert bad == 0, (f"{name}: {bad} of {len(g)} points differ, "
                          f"max |d| {float((g - w).abs().max())}")


def _run(points, body, sign, k=2, nn=None):
    verts, faces, table, normals, cmaps, vis, cross_z, meta = body
    if nn is None:
        nn, _ = nearest_vertices_kernel(points, verts, k)
    kw = {"known": {"known_inside": points[:, 2] > 0.0},
          "columns": {"cross_z": cross_z, "cross_meta": meta},
          "none": {}}[sign]
    args = (points, nn, verts, faces, table, normals, cmaps, vis)
    before = kb.launches_bodyfeat
    got = kb.body_features_kernel(*args, **kw)
    want = kb.point_body_features_plain(*args, **kw)
    torch.cuda.synchronize()
    assert kb.launches_bodyfeat == before + (len(points) > 0)
    return got, want, nn


@pytest.mark.parametrize("case,sign", [("lattice", "columns"),
                                       ("near", "known"), ("near", "columns"),
                                       ("cube", "none")])
def test_kernel_matches_plain(cuda_device, case, sign):
    body = _body(cuda_device)
    if case == "lattice":
        pts = _lattice(33, cuda_device)
    elif case == "near":
        pts = _near(body[0], 20000, 1)
    else:
        rng = np.random.RandomState(2)
        pts = torch.from_numpy(rng.uniform(-1, 1, (20000, 3)).astype(
            np.float32)).to(cuda_device)
    got, want, _ = _run(pts, body, sign)
    _assert_same(got, want)
    if sign == "columns":
        inside = float((got[0] > 0).float().mean())
        assert 0.01 < inside < 0.99


def test_exact_ties_keep_the_first_candidate(cuda_device):
    """On the mirror body's level-0 lattice many points are exactly as far
    from two distinct candidate faces; both versions keep the first."""
    body = _body(cuda_device)
    verts, faces, table = body[:3]
    pts = _lattice(33, cuda_device)
    got, want, nn = _run(pts, body, "columns")
    cand = table[nn.long()].reshape(len(pts), -1)
    packed = verts[faces].reshape(-1, 9)
    d2 = kb.candidate_distances(pts, packed[cand])
    at_min = d2 == d2.min(1, keepdim=True).values
    first = cand[torch.arange(len(pts), device=cuda_device),
                 at_min.int().argmax(1)]
    tied = (at_min & (cand != first[:, None])).any(1)
    assert int(tied.sum()) > 100
    assert torch.equal(got[4], first) and torch.equal(want[4], first)
    _assert_same(got, want)


def test_int32_table_and_other_k(cuda_device):
    """The trainer's int32 table (the frames' is int64), k = 1 and 4."""
    body = _body(cuda_device, subdiv=3, table_dtype=torch.int32)
    pts = _near(body[0], 5000, 3)
    for k in (1, 2, 4):
        got, want, _ = _run(pts, body, "columns", k=k)
        _assert_same(got, want)


def test_empty_n(cuda_device):
    body = _body(cuda_device, subdiv=3)
    pts = torch.zeros((0, 3), device=cuda_device)
    got, want, _ = _run(pts, body, "columns")
    assert [tuple(g.shape) for g in got] == [(0, 1), (0, 3), (0, 3), (0, 1),
                                             (0,)]
    _assert_same(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    verts, faces, table, normals, cmaps, vis, cross_z, meta = \
        _body(cuda_device, subdiv=3)
    pts = _near(verts, 100, 4)
    nn, _ = nearest_vertices_kernel(pts, verts, 2)
    args = [pts, nn, verts, faces, table, normals, cmaps, vis]
    with pytest.raises(RuntimeError, match="requires grad"):
        kb.body_features_kernel(pts.clone().requires_grad_(True), *args[1:])
    with pytest.raises(RuntimeError, match="requires grad"):
        kb.body_features_kernel(*args[:2], verts.clone().requires_grad_(True),
                                *args[3:])
    with pytest.raises(TypeError, match="float32"):
        kb.body_features_kernel(pts.double(), *args[1:])
    with pytest.raises(TypeError, match="int32 or torch.int64"):
        kb.body_features_kernel(*args[:4], table.short(), *args[5:])
    with pytest.raises(TypeError, match="nn_idx must be torch.int32"):
        kb.body_features_kernel(pts, nn.long(), *args[2:])
    with pytest.raises(TypeError, match="faces must be torch.int64"):
        kb.body_features_kernel(*args[:3], faces.int(), *args[4:])
    with pytest.raises(TypeError, match="bool"):
        kb.body_features_kernel(*args,
                                known_inside=pts[:, 0].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kb.body_features_kernel(pts.t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="inputs on"):
        kb.body_features_kernel(*args[:2], verts.cpu(), *args[3:])


def test_two_host_threads_on_one_stream(cuda_device):
    """Two host threads call the wrapper on one stream at once, 200 times
    each on their own points: every result equals the plain twin's (the
    kernel keeps no scratch between calls)."""
    body = _body(cuda_device)
    inputs = [_near(body[0], 30000, 5), _lattice(33, cuda_device)]
    plain = [_run(p, body, "columns")[1] for p in inputs]
    nns = [nearest_vertices_kernel(p, body[0], 2)[0] for p in inputs]
    got = [[] for _ in inputs]
    start = threading.Barrier(len(inputs))
    verts, faces, table, normals, cmaps, vis, cross_z, meta = body

    def work(i):
        start.wait()
        for _ in range(200):
            got[i].append(kb.body_features_kernel(
                inputs[i], nns[i], verts, faces, table, normals, cmaps, vis,
                cross_z=cross_z, cross_meta=meta))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(inputs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # the threads trade the GIL often
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    for i, want in enumerate(plain):
        assert len(got[i]) == 200
        for out in got[i]:
            _assert_same(out, want)


def test_point_body_features_on_the_card(cuda_device, monkeypatch):
    """ops/sdf_fast.py:point_body_features on the card, for every sign,
    equal to the same function with the plain twin in the kernel's place:
    the kernel launched once a call."""
    v, f = synthetic_body(subdiv=3)
    verts, faces, table, normals, cmaps, vis, cross_z, meta = \
        _body(cuda_device, subdiv=3)
    pts = torch.cat([_near(verts, 3000, 6), _lattice(17, cuda_device)])
    rb, rg = sf.build_ray_bins(v, f)
    cf, cm = sf.build_winding_clusters(v, f, 64)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=cuda_device)

    signs = {"known": {"known_inside": pts[:, 2] > 0.0},
             "columns": {"cross_z": cross_z, "cross_meta": meta},
             "ray": {"ray_bins": t(rb), "ray_grid": t(rg)},
             "clusters": {"cluster_faces": t(cf), "cluster_mask": t(cm)},
             "pseudo-normal": {}}
    args = (pts, verts, faces, table, cmaps, vis)
    for name, kw in signs.items():
        before = kb.launches_bodyfeat
        got = sf.point_body_features(*args, **kw)
        torch.cuda.synchronize()
        assert kb.launches_bodyfeat == before + 1, name
        with monkeypatch.context() as m:
            m.setattr(sf, "body_features_kernel",
                      kb.point_body_features_plain)
            want = sf.point_body_features(*args, **kw)
        _assert_same(got, want)
        inside = float((got[0] > 0).float().mean())
        assert 0.01 < inside < 0.99, (name, inside)


def test_nan_candidates(cuda_device):
    """Corners made NaN: a point whose candidates include a NaN face picks
    the first NaN candidate, as torch.argmin does, and every output equals
    the twin's (NaN where the twin's is NaN)."""
    body = list(_body(cuda_device))
    verts = body[0]
    pts = _near(verts, 20000, 7)
    nn, _ = nearest_vertices_kernel(pts, verts, 2)
    bad = torch.from_numpy(np.random.RandomState(8).randint(
        0, len(verts), 300)).to(cuda_device)
    body[0] = verts.clone()
    body[0][bad] = float("nan")
    for sign in ("columns", "known", "none"):
        got, want, _ = _run(pts, body, sign, nn=nn)
        _assert_same(got, want, nan=True)
        assert 0.01 < float(torch.isnan(got[0]).float().mean()) < 0.9


@pytest.mark.parametrize("k,deg", [(2, 5), (3, 5), (1, 3), (5, 7), (8, 8),
                                   (4, 8), (1, 1), (1, 2)])
def test_candidate_counts(cuda_device, k, deg):
    """k x deg = 10, 15, 3, 35, 64, 32, 1 and 2 candidates: groups of 4
    lanes with 3 to 16 candidates a lane, uneven or one lane idle, and
    groups of 1 and 2; the table cut to its first deg slots (a narrower
    table of the same body)."""
    body = list(_body(cuda_device, subdiv=4))
    body[2] = body[2][:, :deg].contiguous()
    pts = torch.cat([_near(body[0], 6000, 9), _lattice(17, cuda_device)])
    for sign in ("columns", "none"):
        got, want, _ = _run(pts, body, sign, k=k)
        _assert_same(got, want)


@pytest.mark.parametrize("n", [1, 17, 33])
def test_few_points(cuda_device, n):
    """N = 1, 17 and 33: the last warp's second group, and the last
    block's groups, lie past the end and write nothing."""
    body = _body(cuda_device, subdiv=3)
    pts = _near(body[0], n, 10)
    for sign in ("columns", "known"):
        got, want, _ = _run(pts, body, sign)
        assert len(got[0]) == n
        _assert_same(got, want)


def test_records_per_call_and_once_a_body(cuda_device):
    """The record kernel's output equals its plain builder's bit for bit;
    the body-feature kernel launched on records built once for the body
    equals the wrapper's, which builds them each call."""
    verts, faces, table, normals, cmaps, vis, cross_z, meta = \
        _body(cuda_device)
    rec = kb.face_records(verts, faces)
    want = kb.face_records_plain(verts, faces)
    torch.cuda.synchronize()
    assert rec.shape == (len(faces), kb.RECORD_WORDS)
    assert torch.equal(rec.view(torch.int32), want.view(torch.int32))
    for pts in (_near(verts, 30000, 11), _lattice(33, cuda_device)):
        nn, _ = nearest_vertices_kernel(pts, verts, 2)
        args = (pts, nn, verts, faces, table, normals, cmaps, vis)
        per_call = kb.body_features_kernel(*args, cross_z=cross_z,
                                           cross_meta=meta)
        once = tuple(torch.empty_like(o) for o in per_call)
        kb._launch(*args, None, cross_z, meta, once, rec)
        torch.cuda.synchronize()
        _assert_same(once, per_call)


def test_graph_capture_replays_bit_equal(cuda_device):
    """One wrapper call captured in a torch.cuda.graph (the record build
    and the kernel, buffers from the graph's pool, nothing read back) and
    replayed on new points in the captured buffers equals an eager call
    on those points."""
    verts, faces, table, normals, cmaps, vis, cross_z, meta = \
        _body(cuda_device)
    pts = _near(verts, 30000, 12)
    nn, _ = nearest_vertices_kernel(pts, verts, 2)
    args = (pts, nn, verts, faces, table, normals, cmaps, vis)
    kw = {"cross_z": cross_z, "cross_meta": meta}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture
        kb.body_features_kernel(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kb.body_features_kernel(*args, **kw)
    new = _near(verts, 30000, 13)
    new_nn, _ = nearest_vertices_kernel(new, verts, 2)
    pts.copy_(new)
    nn.copy_(new_nn)
    graph.replay()
    torch.cuda.synchronize()
    want = kb.point_body_features_plain(*args, **kw)
    _assert_same(captured, want)
    _assert_same(captured, kb.body_features_kernel(*args, **kw))
