"""Port parity, the non-blocking serving dispatch: ``Frame.serve`` (the
2-deep loop of bench.py, its decode on a worker thread) against the same
loop written here on the JAX package's engine (``auto_budget``) and
``AutoMarcher(codec="lattice")``, at image 64^2 with a subdiv-3 body and
res 128, as tests/test_torch_frame.py builds them; and the lazy counts of
the port's engine and marcher, driven through a stub copy whose landing the
test decides.

Frame by frame the level counts and faces are identical and the vertices
agree to the wire's u8 fraction step (test_frame_parity's bound);
``serve``'s meshes equal ``frame()``'s. Which branch JAX's own lazy read
takes on the CPU depends on its asynchronous dispatch, so the tests compare
only what no branch changes: counts, meshes and the bucket ladder."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import icon_cfg, init_jax_icon, port_cfg, port_state

from icon_tpu.utils.synthetic import synthetic_icon_batch
from icon_tpu_torch.recon import engine as P
from icon_tpu_torch.recon import marching as PM

RES = 128
FRAMES = 4
V_ATOL = 1 / 255 + 1e-6      # test_frame_parity's: one u8 fraction step


def _jax_compute(jnet, variables, batch, res):
    """bench.py:137-226's ``compute`` and ``marcher`` at a small size: the
    frame's device work up to the pack, and the marcher that unpacks it."""
    from icon_tpu.ops.sdf_fast import (build_column_bins,
                                       build_crossing_columns_blocked,
                                       build_vertex_face_table)
    from icon_tpu.recon.engine import ReconEngine, reconstruction_resolutions
    from icon_tpu.recon.marching import AutoMarcher
    from icon_tpu.utils.synthetic import clothed_human_occ

    b = {k: jnp.asarray(v) for k, v in batch.items()}
    eng = ReconEngine(reconstruction_resolutions(res), faster=True,
                      auto_budget=True, auto_headroom=1.3)
    smpl = {k: b[k] for k in ("smpl_verts", "smpl_faces", "smpl_cmap",
                              "smpl_vis")}
    smpl["smpl_vf_table"] = jnp.asarray(build_vertex_face_table(
        batch["smpl_faces"], batch["smpl_verts"].shape[1]))
    res1 = res + 1
    col_x = np.linspace(-1.0, 1.0, res1, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, res1, dtype=np.float32)
    cb, cm, tids = build_column_bins(batch["smpl_verts"][0],
                                     batch["smpl_faces"], col_x, col_y,
                                     compact=True)
    smpl["smpl_cross_meta"] = jnp.asarray(
        [-1.0, 1.0, (res1 - 1) / 2.0, (res1 - 1) / -2.0, float(res1),
         float(res1)], jnp.float32)
    columns = jax.jit(lambda v: build_crossing_columns_blocked(
        v, smpl["smpl_faces"], jnp.asarray(cb), jnp.asarray(cm),
        jnp.asarray(col_x), jnp.asarray(col_y), tile_ids=jnp.asarray(tids)))
    features = jnet.apply(variables, {"normal_F": b["normal_F"],
                                      "normal_B": b["normal_B"]}, False,
                          method=jnet.filter)

    def query_fn(pts, cross_z):
        preds = jnet.apply(variables, features, pts, b["calib"],
                           dict(smpl, smpl_cross_z=cross_z), False,
                           method=jnet.query)[-1]
        return preds * 1e-6 + clothed_human_occ(pts)[..., None]

    marcher = AutoMarcher(max_cells=1 << 18, max_tris=1 << 19,
                          max_verts=1 << 19, slice_one=True, codec="lattice")

    def compute():
        cz, _ = columns(b["smpl_verts"][0])
        occ, stats = eng(query_fn, jit_levels=True, query_args=(cz,))
        mesh = marcher(occ, coarse_occ=stats["coarse_occ"])
        return marcher.pack(mesh), mesh, stats

    return compute, marcher


def _jax_pipelined(compute, marcher, n):
    """bench.py:246-258's loop (b): frame i+1 is enqueued before frame i is
    unpacked; each frame's (stats, verts, faces) in order."""
    out = []
    pending = compute()
    for i in range(n):
        nxt = compute() if i + 1 < n else None
        verts, faces = marcher.unpack(pending[0])
        out.append((pending[2], verts, faces))
        pending = nxt
    return out


@pytest.fixture(scope="module")
def frames():
    from icon_tpu_torch.recon.frame import build_frame
    cfg = icon_cfg()
    jnet, variables = init_jax_icon(cfg, seed=1)
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=64, n_samples=64, subdiv=3)
    jloop = _jax_compute(jnet, variables, batch, RES)
    pframe = build_frame(port_cfg(cfg), port_state(variables), batch, RES,
                         "cpu")
    return jloop, pframe


def test_serve_matches_the_jax_pipelined_loop(frames):
    (jcompute, jmarcher), pframe = frames
    want = _jax_pipelined(jcompute, jmarcher, FRAMES)
    got = pframe.serve(FRAMES)
    assert len(got) == FRAMES
    for (stats, verts, faces), (jstats, jv, jf) in zip(got, want):
        for k in ("level1_points", "level1_overflow"):
            assert int(stats[k]) == int(jstats[k]), k
        assert int(stats["level1_points"]) > 1000
        assert len(faces) > 10000
        np.testing.assert_array_equal(faces, jf)
        np.testing.assert_allclose(verts, jv, rtol=0, atol=V_ATOL)
        assert (np.abs(verts - jv) > 1e-5).mean() < 1e-3
    assert pframe.engine._bucket_used[1] < pframe.engine.budgets[0]


def test_serve_equals_frame(frames):
    """With the buckets settled, every served frame's counts and mesh are
    those of a blocking ``frame()`` on the same input."""
    _, pframe = frames
    pframe.frame()
    served = pframe.serve(FRAMES)
    stats, _, verts, faces = pframe.frame()
    for s, v, f in served:
        assert int(s["level1_points"]) == int(stats["level1_points"])
        np.testing.assert_array_equal(f, faces)
        np.testing.assert_array_equal(v, verts)


class StubCopy:
    """A count's copy to the host whose landing the test decides;
    ``wait`` counts the waits it would have blocked in."""

    def __init__(self, value, landed: bool):
        self.value = torch.tensor(value)
        self.landed = landed
        self.blocked = 0

    def ready(self) -> bool:
        return self.landed

    def wait(self) -> torch.Tensor:
        self.blocked += not self.landed
        return self.value


def _jax_bucket(n: int) -> int:
    """The JAX engine's level-1 bucket for a landed count ``n``."""
    from icon_tpu.recon.engine import ReconEngine
    jeng = ReconEngine((33, 65, 129), auto_budget=True)
    jeng._last_counts[1] = jnp.asarray(n)
    return jeng._bucket(1)


def test_engine_counts_are_lazy():
    """The first count of a level is taken even before its copy lands (one
    start-up wait); a later count whose copy has not landed keeps the last
    bucket, waits for nothing and stays pending until it lands; an
    overflow, or a count of 0, resets to the cap. The ladder is the JAX
    engine's."""
    eng = P.ReconEngine((33, 65, 129), auto_budget=True, device="cpu")
    cap = eng.budgets[0]
    assert eng._bucket(1) == cap                     # nothing measured yet
    first = StubCopy(5000, landed=False)
    eng._last_counts[1] = first
    b1 = eng._bucket(1)
    assert b1 == _jax_bucket(5000) < cap and first.blocked == 1
    assert 1 not in eng._last_counts
    later = StubCopy(40000, landed=False)
    eng._last_counts[1] = later
    for _ in range(3):
        assert eng._bucket(1) == b1
    assert later.blocked == 0 and eng._last_counts[1] is later
    later.landed = True
    b2 = eng._bucket(1)
    assert b2 == _jax_bucket(40000) and b1 < b2 < cap and later.blocked == 0
    for n in (cap + 1, 0):
        eng._last_counts[1] = StubCopy(n, landed=True)
        assert eng._bucket(1) == cap == eng._bucket_used[1]
    eng._last_counts[1] = StubCopy(5000, landed=False)
    assert eng._bucket(1) == cap        # the reset bucket until it lands


def test_engine_stamps_a_host_copy_a_level():
    """A CPU engine's counts are always landed and pin nothing; each level
    of a frame leaves its count's copy for the next frame."""
    eng = P.ReconEngine((33, 65, 129), auto_budget=True, device="cpu")

    def field(pts):
        rad = torch.linalg.norm(pts / torch.tensor([0.45, 0.7, 0.2]),
                                dim=-1, keepdim=True)
        return torch.sigmoid((1.0 - rad) * 25.0)

    _, stats = eng(field)
    copy = eng._last_counts[1]
    assert isinstance(copy, P.HostCopy) and copy.ready()
    assert copy.event is None and copy.wait() is copy.host
    assert int(copy.wait()) == int(stats["level1_points"]) > 0
    assert eng._bucket(1) == _jax_bucket(int(stats["level1_points"]))
    assert 1 not in eng._last_counts


def _march_input():
    g = np.linspace(-1, 1, 41, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2)
    return torch.from_numpy((1.0 / (1.0 + np.exp((r - 0.8) * 12)))
                            .astype(np.float32))


def test_marcher_counts_are_lazy():
    """As the engine's: the first march's counts are taken at once, a later
    march's only once landed (the last landed serve meanwhile, for the
    buffer sizes and the pack sizes alike), and an overflow resets the
    buffers to the caps."""
    occ = _march_input()
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice")
    out = m(occ)
    real = m._last
    assert isinstance(real, P.HostCopy) and real.ready()
    counts = [int(v) for v in real.wait()]
    first = StubCopy(counts, landed=False)
    m._last = first
    sizes = m._sizes()
    assert first.blocked == 1 and m._counts_host == tuple(counts)
    assert sizes[0] < m.caps[0] and sizes[2] < m.caps[2]
    later = StubCopy([4 * c for c in counts], landed=False)
    m._last = later
    assert m._sizes() == sizes and later.blocked == 0
    (_, nvb, ncb), _, _ = m.pack(out)
    h = m.headroom
    want = PM.pack_lattice(out, sizes=(int(counts[1] * h),
                                       int(counts[0] * h)))
    assert (nvb, ncb) == want[1:] and m._last is later
    later.landed = True
    assert m._sizes() != sizes and m._counts_host == tuple(
        4 * c for c in counts)
    m._last = StubCopy([m.caps[0] + 1] + counts[1:], landed=True)
    assert m._sizes() == m.caps


@pytest.mark.parametrize("codec", ["lattice", "indexed"])
def test_pack_token_decodes_from_its_host_copy(codec):
    """A pack token carries its buffer's host copy; ``decode`` reads it and
    gives ``unpack``'s mesh and the decode of the device buffer itself."""
    occ = _march_input()
    m = PM.AutoMarcher(max_cells=1 << 15, max_tris=1 << 16,
                       max_verts=1 << 16, codec=codec)
    m(occ)                                      # the counts for the sizes
    out = m(occ)
    token = m.pack(out)
    (copy, n0, n1), _, meta = token
    assert isinstance(copy, P.HostCopy) and copy.ready()
    verts, faces, overflow = m.decode(token)
    assert not overflow and len(faces) > 1000
    v2, f2 = m.unpack(token)
    np.testing.assert_array_equal(f2, faces)
    np.testing.assert_array_equal(v2, verts)
    if codec == "lattice":
        v3, f3 = PM.decode_lattice((copy.host, n0, n1), *meta)
    else:
        v3, f3 = PM.unpack_mesh((copy.host, n0, n1), quantize=meta)
    np.testing.assert_array_equal(f3, faces)
    np.testing.assert_array_equal(v3, verts)


def test_overflowed_token_repacks_in_serve_frames():
    """``serve_frames`` re-packs a frame whose pack overflowed on its own
    thread, at full size, and keeps the frames' order."""
    from icon_tpu_torch.recon.frame import serve_frames
    occ = _march_input()
    m = PM.AutoMarcher(max_cells=1 << 15, max_verts=1 << 16,
                       codec="lattice")
    full = m.unpack(m.pack(m(occ)))
    calls = []

    def compute():
        out = m(occ)
        i = len(calls)
        calls.append(i)
        if i == 1:                  # a pack far below the frame's counts
            buf = PM.pack_lattice(out, sizes=(64, 64), bucket=64,
                                  implicit_eid=True)
            return ((P.HostCopy(buf[0]), *buf[1:]), out, m._dims), out, \
                {"i": i}
        return m.pack(out), out, {"i": i}

    served = serve_frames(compute, m, 3)
    assert [s["i"] for s, _, _ in served] == [0, 1, 2]
    for _, verts, faces in served:
        np.testing.assert_array_equal(faces, full[1])
        np.testing.assert_array_equal(verts, full[0])


def test_device_constants_are_made_once():
    from icon_tpu_torch.ops.constants import device_constant
    a = device_constant(P.B_MIN, torch.float32, "cpu")
    assert a is device_constant(P.B_MIN, torch.float32, torch.device("cpu"))
    assert torch.equal(a, torch.tensor(P.B_MIN, dtype=torch.float32))
    b = device_constant(P.B_MIN, torch.float64, "cpu")
    assert b is not a and b.dtype == torch.float64
    pts = torch.rand(5, 3)
    bmin, bmax = torch.tensor(P.B_MIN), torch.tensor(P.B_MAX)
    assert torch.equal(P._grid_to_world(pts), pts * (bmax - bmin) + bmin)
