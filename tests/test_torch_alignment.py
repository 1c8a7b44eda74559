"""Port parity, the HPS alignment harness: ``TestDataset.visualize_alignment``
of icon_tpu_torch against the JAX package's on the item pinned by
``tests/test_alignment_viz.py::test_visualize_alignment_writes_panel``
(a 96^2 RGBA photo at icon size 64, the canonical body: identity
rotations, zero betas, scale 1, no translation). Each dataset's HPS is a
stub that holds its package's 24-joint synthetic SMPL body and returns
that fit, so no HPS net is built. The two PNG strips are equal byte for
byte: the rasters agree on every pixel's face, and the normals' u8 steps
agree. Then ``main(argv, device="cpu")`` over a folder of that one photo,
with ``get_hps`` stubbed, writes the strip at the CLI's icon size, 512,
within ``U8_STEPS`` of the JAX package's on ``U8_SHARE`` of its values."""

import numpy as np
import pytest
from PIL import Image

ICON_SIZE = 64
# the CLI's 512^2 panel against the JAX package's: at most one u8 step, on
# at most 1e-5 of the values (5 of 2,359,296 measured)
U8_STEPS = 1
U8_SHARE = 1e-5


class StubHPS:
    """A PyMAF-shaped HPS that returns the canonical fit of ``body``."""
    random_init = False

    def __init__(self, body):
        self.body = body
        self.faces = body.faces

    def __call__(self, img):
        n = self.body.v_template.shape[0]
        return {"rotmat": np.broadcast_to(np.eye(3, dtype=np.float32),
                                          (1, 24, 3, 3)).copy(),
                "verts": np.zeros((1, n, 3), np.float32),
                "pred_cam": np.array([[1.0, 0.0, 0.0]], np.float32),
                "pred_shape": np.zeros((1, 10), np.float32)}


@pytest.fixture
def photo_dir(tmp_path):
    """The pinned test's photo: colour noise with an ellipse as alpha."""
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(0)
    rgba = np.zeros((96, 96, 4), np.uint8)
    rgba[..., :3] = (rng.rand(96, 96, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:96, :96]
    body = ((yy - 48) ** 2 / 40.0 ** 2 + (xx - 48) ** 2 / 20.0 ** 2) < 1
    rgba[..., 3] = body * 255
    Image.fromarray(rgba).save(d / "person.png")
    return d


def _jax_panel(photo_dir, out, icon_size=ICON_SIZE):
    from icon_tpu.data.test_dataset import TestDataset
    from icon_tpu.models.pymaf.net import _synthetic_smpl24
    ds = TestDataset(str(photo_dir), hps_type="pymaf", icon_size=icon_size)
    ds._hps = StubHPS(_synthetic_smpl24())
    return ds.visualize_alignment(ds[0], out)


def test_visualize_alignment_matches_jax(photo_dir, tmp_path):
    from icon_tpu_torch.data.test_dataset import TestDataset
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24
    want = _jax_panel(photo_dir, str(tmp_path / "jax.png"))
    ds = TestDataset(str(photo_dir), hps_type="pymaf", icon_size=ICON_SIZE,
                     device="cpu")
    ds._hps = StubHPS(_synthetic_smpl24())
    item = ds[0]
    assert item["scale"] == 1.0 and not item["trans"].any()
    got = ds.visualize_alignment(item, str(tmp_path / "torch.png"))
    panel = np.asarray(Image.open(got))
    assert panel.shape == (ICON_SIZE, 3 * ICON_SIZE, 3)
    front = panel[:, ICON_SIZE:2 * ICON_SIZE].astype(np.float32) / 255.0
    assert (np.abs(front - 0.5).max(-1) > 0.2).mean() > 0.01
    np.testing.assert_array_equal(panel, np.asarray(Image.open(want)))
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_alignment_cli_runs(photo_dir, tmp_path, monkeypatch):
    """``main`` with the JAX CLI's flags over one photo writes
    ``<name>_alignment.png`` (the CLI's icon size, 512), equal to the JAX
    package's panel of the same fit; a random-init HPS is refused unless
    ``--allow_random_hps``."""
    from icon_tpu_torch.data import test_dataset as td
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24
    asked = []

    def get_hps(hps_type, ckpt="", device="cuda"):
        asked.append((hps_type, ckpt, str(device)))
        return StubHPS(_synthetic_smpl24())
    monkeypatch.setattr(td, "get_hps", get_hps)
    out = tmp_path / "out"
    paths = td.main(["-i", str(photo_dir), "-o", str(out), "--hps_type",
                     "pymaf", "--hps_ckpt", "none.pt"], device="cpu")
    assert paths == [str(out / "person_alignment.png")]
    assert asked == [("pymaf", "none.pt", "cpu")]
    want = _jax_panel(photo_dir, str(tmp_path / "jax.png"), 512)
    got = np.asarray(Image.open(paths[0])).astype(np.int16)
    diff = np.abs(got - np.asarray(Image.open(want)).astype(np.int16))
    assert got.shape == (512, 3 * 512, 3)
    # at 512^2 a few interpolated normals, float32 sums in another order
    # than XLA's, land on the other side of a u8 step
    assert int(diff.max()) <= U8_STEPS and \
        float((diff > 0).mean()) <= U8_SHARE

    def random_hps(hps_type, ckpt="", device="cuda"):
        hps = StubHPS(_synthetic_smpl24())
        hps.random_init = True
        return hps
    monkeypatch.setattr(td, "get_hps", random_hps)
    with pytest.raises(RuntimeError, match="allow_random_hps"):
        td.main(["-i", str(photo_dir), "-o", str(out)], device="cpu")
    assert td.main(["-i", str(photo_dir), "-o", str(out),
                    "--allow_random_hps"], device="cpu") == paths
