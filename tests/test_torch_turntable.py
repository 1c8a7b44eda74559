"""Port parity, the demo's turntable video and garments on the CPU:
``render/render.py:make_turntable_renderer``, ``apps/infer.py:
export_turntable_video`` and ``extract_garments`` against the JAX
package's ``make_turntable_renderer``, ``_export_turntable_video`` and
``_extract_garments``.

The frames of both packages are captured by monkeypatching each package's
``save_video``: two seeded coloured meshes (the subdiv-4 synthetic body,
5,120 faces, so every 32-pixel tile drops faces past K=128 in both) at 64^2
with 6 frames, uint8, at most one step apart on at most 0.1% of the values
(edge pixels where the float colours round across a step; none on these
inputs). One renderer call to 1e-6. The garments of a seeded polygon JSON:
the same OBJ files, byte for byte."""

import json
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icon_tpu.utils.io as JIO
import icon_tpu_torch.utils.io as PIO
from icon_tpu.apps.infer import _export_turntable_video, _extract_garments
from icon_tpu.render.render import make_turntable_renderer as jrenderer
from icon_tpu_torch.apps.infer import export_turntable_video, \
    extract_garments
from icon_tpu_torch.render.render import make_turntable_renderer
from icon_tpu_torch.utils.synthetic import synthetic_body

SIZE, N_FRAMES = 64, 6


@pytest.fixture(scope="module")
def scene():
    v, f = synthetic_body(subdiv=4)
    rng = np.random.RandomState(0)
    meshes = [(v * 0.8, rng.rand(len(v), 3).astype(np.float32)),
              ((v * 0.7 + 0.03 * rng.randn(*v.shape)).astype(np.float32),
               rng.rand(len(v), 3).astype(np.float32))]
    image, nml = rng.uniform(-1.1, 1.1, (2, 96, 96, 3)).astype(np.float32)
    return image, nml, meshes, f


def test_renderer_matches_jax(scene):
    _, _, meshes, f = scene
    v, c = meshes[1]
    a = np.radians(40.0)
    rot = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                    [np.sin(a), 0, np.cos(a)]], np.float32)
    v_rot = v @ rot.T
    want = np.asarray(jrenderer(jnp.asarray(f), jnp.asarray(c), size=SIZE,
                                K=128)(jnp.asarray(v_rot)))
    got = make_turntable_renderer(torch.from_numpy(f).long(),
                                  torch.from_numpy(c), size=SIZE,
                                  K=128)(torch.from_numpy(v_rot))
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # K=128 keeps 512 of the 5,120 faces here; those cover some pixels
    assert (want != 0.5).any(-1).mean() > 0.01


def test_turntable_frames_match_jax(scene, monkeypatch):
    image, nml, meshes, f = scene
    frames = {}

    def capture(key):
        def save(path, fr, fps=30):
            frames[key] = (path, np.stack(fr), fps)
        return save

    monkeypatch.setattr(JIO, "save_video", capture("jax"))
    monkeypatch.setattr(PIO, "save_video", capture("port"))
    _export_turntable_video("x/a_cloth.mp4", image, nml, meshes, f,
                            size=SIZE, n_frames=N_FRAMES)
    export_turntable_video("x/a_cloth.mp4", image, nml, meshes, f,
                           size=SIZE, n_frames=N_FRAMES, device="cpu")
    (jp, want, jfps), (pp, got, pfps) = frames["jax"], frames["port"]
    assert (pp, pfps) == (jp, jfps) == ("x/a_cloth.mp4", 30)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (N_FRAMES, SIZE, 4 * SIZE, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # the meshes turn: the frames differ, the panels do not
    assert (want[0, :, 2 * SIZE:] != want[N_FRAMES // 2, :, 2 * SIZE:]).any()
    assert (want[:, :, :2 * SIZE] == want[:1, :, :2 * SIZE]).all()


def test_garments_match_jax(scene, tmp_path):
    _, _, meshes, f = scene
    v = meshes[0][0]
    segs = [{"type": "upper", "coordinates": [[150, 120, 360, 120, 360, 250,
                                               150, 250]]},
            {"type": "skirt", "coord": [[100, 250, 400, 250, 250, 480]]},
            {"type": "none", "coordinates": [[0, 0, 5, 0, 5, 5]]},
            {"type": "nothing"}]
    (tmp_path / "segs").mkdir()
    with open(tmp_path / "segs" / "a.json", "w") as fh:
        json.dump(segs, fh)
    for out in ("jax", "port"):
        (tmp_path / out).mkdir()
    _extract_garments(types.SimpleNamespace(
        seg_dir=str(tmp_path / "segs"), out_dir=str(tmp_path / "jax")),
        "a", v, f, None, None)
    written = extract_garments(str(tmp_path / "segs"),
                               str(tmp_path / "port"), "a", v, f)
    assert sorted(written) == ["skirt", "upper"]
    for kind, (nv, nf) in written.items():
        port = (tmp_path / "port" / f"a_{kind}.obj").read_bytes()
        assert port == (tmp_path / "jax" / f"a_{kind}.obj").read_bytes()
        assert port.count(b"\nv ") + 1 == nv and port.count(b"\nf ") == nf
        assert 50 < nf < len(f)
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        sorted(p.name for p in (tmp_path / "port").iterdir())
    assert extract_garments(str(tmp_path / "segs"), str(tmp_path / "port"),
                            "b", v, f) == {}
