"""Port parity, the demo's photo dataset (``icon_tpu_torch.data.
test_dataset.TestDataset``): the port's items against the JAX package's on
the same two photos (an RGBA matte and an RGB scene that takes the saliency
path), with both packages' ``get_hps`` monkeypatched to one small-width
PyMAF (``torch_port_helpers.pymaf_pair``; nothing of the JAX package is
edited): the images, masks and crop parameters byte-equal, the estimate
(betas, rotations, vertices, scale, translation) to 1e-4. Installed
U^2-Net (full, lite) and YOLO weight files, written from seeds in their
published layouts, are used by both datasets on the RGB photo alike. PARE
through ``get_hps`` and ``TestDataset`` against the JAX ``PAREWrapper`` on
one seeded checkpoint; PIXIE and HybrIK through the datasets with both
packages' wrappers around narrow nets (``torch_port_helpers.pixie_pair``,
``hybrik_pair``) and BEV through a stubbed ``simple-romp`` package, each
item equal to the JAX dataset's. Then the guards: no checkpoint without
``allow_random_hps``, an unknown ``hps_type``, BEV without its package."""

import pickle
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from torch_port_helpers import hybrik_pair, pixie_pair, pymaf_pair

ATOL = 1e-4


class _Hps:
    def __init__(self, fwd, body):
        self.fwd, self.body = fwd, body
        self.faces = np.asarray(body.faces)
        self.random_init = False

    def __call__(self, img):
        return self.fwd(img)["smpl_out"][-1]


class _PareHps(_Hps):
    def __call__(self, img):
        return self.fwd(img)


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24
    from icon_tpu_torch.utils.synthetic import synthetic_photos
    d = tmp_path_factory.mktemp("photos")
    rgba, rgb = synthetic_photos(_synthetic_smpl24(subdiv=2), 120, seed=1)
    Image.fromarray(rgba).save(d / "a_matte.png")
    Image.fromarray(rgb).save(d / "b_scene.jpg", quality=95)
    return str(d)


@pytest.fixture(scope="module")
def hps_pair():
    """Both packages' HPS callables around one small-width PyMAF."""
    jnet, variables, pnet, (jbody, pbody, _) = pymaf_pair()
    jfwd = jax.jit(lambda x: jnet.apply(variables, x, train=False))
    return (_Hps(lambda x: jfwd(jnp.asarray(x)), jbody),
            _Hps(lambda x: pnet(x), pbody))


def _items(photos, monkeypatch, hps_pair, indices=(0, 1)):
    """The port's and the JAX dataset's items of ``photos``, both with the
    small PyMAF of ``hps_pair``; and the port's dataset."""
    import icon_tpu.data.test_dataset as J
    import icon_tpu_torch.data.test_dataset as P
    jhps, phps = hps_pair
    monkeypatch.setattr(J, "get_hps", lambda *a, **k: jhps)
    monkeypatch.setattr(P, "get_hps", lambda *a, **k: phps)
    jds = J.TestDataset(photos, icon_size=96)
    pds = P.TestDataset(photos, icon_size=96, device="cpu")
    assert len(pds) == len(jds) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        items = [(pds[i], jds[i]) for i in indices]
    return items, pds


def _assert_items_equal(items):
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


def test_items_match_the_jax_dataset(photos, monkeypatch, hps_pair):
    items, _ = _items(photos, monkeypatch, hps_pair)
    _assert_items_equal(items)
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
                                          hps_pair, name):
    """Installed weights (A8 (rest), now ported; the test keeps its
    earlier name): a seeded file in the published layout under
    ``ICON_TPU_DATA_DIR/HPS`` is built on the dataset's device and used on
    the RGB photo, as the JAX dataset uses it; the items are equal as
    above. A file that does not load raises: no saliency fallback."""
    import torch
    from icon_tpu_torch.models import u2net, yolo
    from icon_tpu_torch.utils.synthetic import (seeded_u2net_state,
                                                write_darknet_weights)
    hps = tmp_path / "HPS"
    hps.mkdir()
    if name == "yolov3-tiny.weights":
        write_darknet_weights(str(hps / name), np.random.RandomState(4),
                              head="frame")
    else:
        torch.save(seeded_u2net_state(name == "u2netp.pth", 5), hps / name)
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    items, pds = _items(photos, monkeypatch, hps_pair, indices=(1,))
    _assert_items_equal(items)
    if name.startswith("u2net"):
        assert isinstance(pds.segmenter, u2net.Segmenter)
        assert pds.segmenter.net.stage1.rebnconv1.conv_s1.out_channels == \
            (16 if name == "u2netp.pth" else 32)
        assert pds.detector is None
    else:
        assert isinstance(pds.detector, yolo.PersonDetector)
        assert pds.segmenter is None
    (hps / name).write_bytes(b"\0" * 64)
    with pytest.raises((RuntimeError, ValueError, pickle.UnpicklingError)):
        type(pds)(photos, allow_random_hps=True, device="cpu")[1]


def test_other_hps_types_raise(monkeypatch):
    """Every HPS of the demo is ported (A8): an unknown ``hps_type`` raises,
    naming the five; ``bev`` without the external ``simple-romp`` package
    raises, naming it."""
    import sys
    from icon_tpu_torch.data.test_dataset import get_hps
    with pytest.raises(NotImplementedError,
                       match="pymaf, pare, hybrik, pixie, bev"):
        get_hps("romp", device="cpu")
    monkeypatch.setitem(sys.modules, "bev", None)
    with pytest.raises(RuntimeError, match="simple-romp"):
        get_hps("bev", device="cpu")


def _wrapper(cls, **attrs):
    """An instance of the HPS wrapper ``cls`` holding ``attrs`` (the nets
    of a test), so that its own ``__call__`` runs."""
    w = cls.__new__(cls)
    w.__dict__.update(random_init=False, **attrs)
    return w


def _hps_items(photos, monkeypatch, hps_type, jhps, phps):
    import icon_tpu.data.test_dataset as J
    import icon_tpu_torch.data.test_dataset as P
    for mod, hps in ((J, jhps), (P, phps)):
        monkeypatch.setattr(mod, "get_hps", lambda *a, _h=hps, **k: _h)
    jds = J.TestDataset(photos, hps_type=hps_type, icon_size=96)
    pds = P.TestDataset(photos, hps_type=hps_type, icon_size=96,
                        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return [(pds[i], jds[i]) for i in range(2)]


def test_pixie_items_match_the_jax_dataset(photos, monkeypatch):
    """``-hps_type pixie``: both ``PIXIEWrapper``s around one narrow PIXIE
    (the JAX package's estimator takes the ImageNet-normalized crop and
    normalizes it again, and so does the port's): the SMPL-X items equal,
    with the 21-joint body pose, the whole shape vector as betas, and the
    expression, jaw and hand poses kept."""
    import icon_tpu.data.test_dataset as J
    import icon_tpu_torch.data.test_dataset as P
    jest, _, pest = pixie_pair()
    items = _hps_items(
        photos, monkeypatch, "pixie",
        _wrapper(J.PIXIEWrapper, est=jest, body=jest.body,
                 faces=jest.body.faces),
        _wrapper(P.PIXIEWrapper, est=pest, body=pest.body,
                 faces=pest.body.faces, device=torch.device("cpu")))
    _assert_items_equal(items)
    for got, want in items:
        assert got["body_pose"].shape == (1, 21, 3, 3)
        assert got["betas"].shape == (1, pest.cfg.n_shape)
        for k in ("exp", "jaw_pose", "left_hand_pose", "right_hand_pose"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=ATOL, err_msg=k)
        assert got["smpl_verts"].shape[1] == len(got["smpl_faces"]) // 2 + 2


def test_hybrik_items_match_the_jax_dataset(photos, tmp_path, monkeypatch):
    """``-hps_type hybrik``: ``get_hps`` takes the default checkpoint path
    under ``ICON_TPU_DATA_DIR`` (a seeded published-width file: the mean
    camera); then both ``HybrIKWrapper``s (each resizing the 224^2 crop to
    256^2 its own way) around one narrow HybrIK on the synthetic SMPL with
    SMPL's tree: the items equal, the camera scale doubled."""
    import icon_tpu.data.test_dataset as J
    import icon_tpu_torch.data.test_dataset as P
    from icon_tpu_torch.utils.synthetic import seeded_hybrik_state
    d = tmp_path / "HPS" / "hybrik_data"
    d.mkdir(parents=True)
    torch.save(seeded_hybrik_state(6), d / "pretrained_w_cam.pth")
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    hps = P.get_hps("hybrik", device="cpu")
    assert isinstance(hps, P.HybrIKWrapper) and not hps.random_init
    out = hps(torch.zeros(1, 224, 224, 3))
    np.testing.assert_allclose(out["pred_camera"][0].numpy(),
                               [0.9, 0.0, 0.0], atol=0.05)
    assert torch.isfinite(out["pred_vertices"]).all()

    jnet, variables, pnet, (jbody, pbody, _) = hybrik_pair(img=256)
    items = _hps_items(
        photos, monkeypatch, "hybrik",
        _wrapper(J.HybrIKWrapper, net=jnet, body=jbody, faces=jbody.faces,
                 variables=variables, _fwd=jax.jit(
                     lambda v, x: jnet.apply(v, x, train=False))),
        _wrapper(P.HybrIKWrapper, net=pnet, body=pbody, faces=pbody.faces,
                 device=torch.device("cpu")))
    _assert_items_equal(items)
    for got, _ in items:
        assert got["body_pose"].shape == (1, 23, 3, 3)


def test_bev_items_match_the_jax_dataset(photos, monkeypatch):
    """``-hps_type bev`` through a stubbed ``simple-romp`` package: both
    datasets hand it the same raw BGR crop (``process_image(...,
    return_raw=True)``) and adapt its output alike; the port's faces are
    its body's (the SMPL model, or the synthetic SMPL without it)."""
    import sys
    import types
    import icon_tpu_torch.data.test_dataset as P
    raw = []

    class FakeBEV:
        def __init__(self, settings):
            assert (settings.mode, settings.show_largest) == ("image", True)

        def __call__(self, bgr):
            raw.append(bgr.copy())
            rs = np.random.RandomState((len(raw) - 1) // 2)
            return {"smpl_thetas": rs.randn(2, 72).astype(np.float32) * 0.3,
                    "smpl_betas": rs.randn(2, 11).astype(np.float32),
                    "verts": rs.randn(2, 6890, 3).astype(np.float32),
                    "cam": np.array([[0.8, 0.1, -0.2]] * 2, np.float32),
                    "cam_trans": np.array([[0.05, 0.3, 2.0]] * 2,
                                          np.float32)}

    fake = types.ModuleType("bev")
    fake.main = types.SimpleNamespace(default_settings=types.SimpleNamespace(
        mode=None, show_largest=None))
    fake.BEV = FakeBEV
    monkeypatch.setitem(sys.modules, "bev", fake)
    phps = P.get_hps("bev", device="cpu")
    assert phps.wants_raw and not phps.random_init
    np.testing.assert_array_equal(phps.faces, phps.body.faces)
    import icon_tpu.data.test_dataset as J
    items = _hps_items(photos, monkeypatch, "bev", J.get_hps("bev"), phps)
    for got, want in items:
        for k in ("image", "mask"):
            assert got[k].tobytes() == want[k].tobytes(), k
        for k in ("betas", "body_pose", "global_orient", "smpl_verts",
                  "trans"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
        assert got["scale"] == want["scale"]
        assert got["body_pose"].shape == (1, 23, 3, 3)
    # per photo the port's dataset asks first, the JAX one second
    assert len(raw) == 4 and raw[0].dtype == np.uint8
    for i in (0, 2):
        np.testing.assert_array_equal(raw[i + 1], raw[i])


def test_pare_items_match_the_jax_dataset(photos, tmp_path, monkeypatch):
    """``-hps_type pare``: ``get_hps`` takes the default checkpoint path
    under ``ICON_TPU_DATA_DIR`` (a seeded published-width file, the seeded
    mean camera); then the pare branch of both datasets' adaptation on one
    narrow PARE (width 8; its state carried into the JAX tree by
    ``port_pare``): the items equal, the estimate to 1e-4."""
    import torch
    import icon_tpu.data.test_dataset as J
    import icon_tpu_torch.data.test_dataset as P
    from icon_tpu.models.pare.convert import port_pare
    from icon_tpu.models.pare.net import PARE as JPARE
    from icon_tpu_torch.models.pare.net import PARE as PPARE
    from icon_tpu_torch.utils.synthetic import seeded_pare_state
    d = tmp_path / "HPS" / "pare_data"
    d.mkdir(parents=True)
    torch.save({"state_dict": {"model." + k: v for k, v in
                               seeded_pare_state(6).items()}},
               d / "pare_checkpoint.ckpt")
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    hps = P.get_hps("pare", device="cpu")
    assert isinstance(hps, P.PAREWrapper) and not hps.random_init
    cam = hps(torch.zeros(1, 224, 224, 3))["pred_cam"][0]
    assert abs(float(cam[0]) - 0.9) < 0.05

    _, _, _, (jbody, pbody, _) = pymaf_pair()

    def smpl(body, b, r):
        return body.forward(betas=b, global_orient=r[:, :1].reshape(-1, 9),
                            body_pose=r[:, 1:].reshape(r.shape[0], -1),
                            pose2rot=False)

    torch.manual_seed(0)
    pnet = PPARE(lambda b, r: smpl(pbody, b, r), 8, (1, 1, 1)).eval()
    jnet = JPARE(smpl_forward=lambda b, r: smpl(jbody, b, r),
                 backbone_width=8, stage_modules=(1, 1, 1))
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    variables, _ = port_pare(
        {k: v.numpy() for k, v in pnet.state_dict().items()},
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    jfwd = jax.jit(lambda x: jnet.apply(variables, x, train=False))
    for mod, hps in ((J, _PareHps(lambda x: jfwd(jnp.asarray(x)), jbody)),
                     (P, _PareHps(pnet, pbody))):
        monkeypatch.setattr(mod, "get_hps", lambda *a, _h=hps, **k: _h)
    jds = J.TestDataset(photos, hps_type="pare", icon_size=96)
    pds = P.TestDataset(photos, hps_type="pare", icon_size=96,
                        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        _assert_items_equal([(pds[i], jds[i]) for i in range(2)])
