"""Port parity, the demo's photo dataset (``icon_tpu_torch.data.
test_dataset.TestDataset``): the port's items against the JAX package's on
the same two photos (an RGBA matte and an RGB scene that takes the saliency
path), with both packages' ``get_hps`` monkeypatched to one small-width
PyMAF (``torch_port_helpers.pymaf_pair``; nothing of the JAX package is
edited): the images, masks and crop parameters byte-equal, the estimate
(betas, rotations, vertices, scale, translation) to 1e-4. Then the guards:
no checkpoint without ``allow_random_hps``, an installed U^2-Net or YOLO
weight file, another ``hps_type``."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from PIL import Image

from torch_port_helpers import pymaf_pair

ATOL = 1e-4


class _Hps:
    def __init__(self, fwd, body):
        self.fwd, self.body = fwd, body
        self.faces = np.asarray(body.faces)
        self.random_init = False

    def __call__(self, img):
        return self.fwd(img)["smpl_out"][-1]


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24
    from icon_tpu_torch.utils.synthetic import synthetic_photos
    d = tmp_path_factory.mktemp("photos")
    rgba, rgb = synthetic_photos(_synthetic_smpl24(subdiv=2), 120, seed=1)
    Image.fromarray(rgba).save(d / "a_matte.png")
    Image.fromarray(rgb).save(d / "b_scene.jpg", quality=95)
    return str(d)


def test_items_match_the_jax_dataset(photos, monkeypatch):
    import icon_tpu.data.test_dataset as J
    import icon_tpu_torch.data.test_dataset as P
    jnet, variables, pnet, (jbody, pbody, _) = pymaf_pair()
    jfwd = jax.jit(lambda x: jnet.apply(variables, x, train=False))
    jhps = _Hps(lambda x: jfwd(jnp.asarray(x)), jbody)
    phps = _Hps(lambda x: pnet(x), pbody)
    monkeypatch.setattr(J, "get_hps", lambda *a, **k: jhps)
    monkeypatch.setattr(P, "get_hps", lambda *a, **k: phps)
    jds = J.TestDataset(photos, icon_size=96)
    pds = P.TestDataset(photos, icon_size=96, device="cpu")
    assert len(pds) == len(jds) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        items = [(pds[i], jds[i]) for i in range(2)]
    for got, want in items:
        assert got["name"] == want["name"]
        for k in ("image", "mask"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
        assert got["crop_param"] == want["crop_param"]
        np.testing.assert_array_equal(got["smpl_faces"], want["smpl_faces"])
        for k in ("betas", "body_pose", "global_orient", "smpl_verts",
                  "trans"):
            assert got[k].shape == np.asarray(want[k]).shape, k
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=ATOL, err_msg=k)
        assert got["scale"] == pytest.approx(want["scale"], abs=ATOL)
        assert got["mask"].sum() > 200
    assert items[0][0]["body_pose"].shape == (1, 23, 3, 3)


def test_random_hps_needs_the_flag(photos):
    from icon_tpu_torch.data.test_dataset import TestDataset
    with pytest.raises(RuntimeError, match="no checkpoint"):
        _ = TestDataset(photos, device="cpu").hps
    hps = TestDataset(photos, allow_random_hps=True, device="cpu").hps
    assert hps.random_init and len(hps.faces) > 1000


@pytest.mark.parametrize("name", ["u2net.pth", "u2netp.pth",
                                  "yolov3-tiny.weights"])
def test_installed_detector_weights_raise(photos, tmp_path, monkeypatch,
                                          name):
    """The JAX package would use these files; the port refuses rather than
    quietly taking the saliency path."""
    from icon_tpu_torch.data.test_dataset import TestDataset
    (tmp_path / "HPS").mkdir()
    (tmp_path / "HPS" / name).write_bytes(b"")
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="A8 \\(rest\\)"):
        TestDataset(photos, allow_random_hps=True, device="cpu")[0]


def test_other_hps_types_raise():
    from icon_tpu_torch.data.test_dataset import get_hps
    for hps_type in ("pare", "pixie", "hybrik", "bev"):
        with pytest.raises(NotImplementedError, match="A8 \\(rest\\)"):
            get_hps(hps_type, device="cpu")
