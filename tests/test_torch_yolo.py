"""Port parity, the YOLOv3-tiny person detector (``icon_tpu_torch.models.
yolo``) against the JAX package's ``icon_tpu.models.yolo`` on the CPU: one
seeded darknet ``.weights`` file (``utils/synthetic.py:
write_darknet_weights``, the published layout) loaded by both packages'
own parsers. The two raw heads to 1e-5 of their largest magnitude; the
decoded boxes to 2e-4 relative (sizes are exp of the heads) and the
scores to 1e-5; the NMS picks, the detections and
``person_bbox`` on seeded photos equal; ``detect_and_matte`` with the
detector to 1e-6; and the demo's frame-boxing file gives a box on any
photo."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icon_tpu.models import detector as JD
from icon_tpu.models import yolo as JY
from icon_tpu_torch.models import detector as PD
from icon_tpu_torch.models import yolo as PY
from icon_tpu_torch.utils.synthetic import write_darknet_weights

HEAD_RTOL = 1e-5          # of each head's largest magnitude (13 convs)
BOX_ATOL = 1e-5
# box sizes are exp(head): a head error of HEAD_RTOL * 13 is 1.3e-4 of a size
BOX_RTOL = 2e-4


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("yolo") / "yolov3-tiny.weights")
    write_darknet_weights(path, np.random.RandomState(0))
    return JY.PersonDetector(path), PY.PersonDetector(path, device="cpu")


def _photo(seed, hw=(300, 220)):
    return np.random.RandomState(seed).rand(*hw, 3).astype(np.float32)


def test_heads_and_decode_match(detectors):
    jd, pd = detectors
    inp, _, _, _ = PY._letterbox(_photo(1))
    jheads = JY.YoloTiny().apply({"params": jd.params},
                                 jnp.asarray(inp)[None])
    pheads = pd.heads(inp)
    for j, p in zip(jheads, pheads):
        j = np.asarray(j)
        assert p.shape == j.shape
        err = float(np.abs(p.numpy() - j).max())
        assert err <= HEAD_RTOL * float(np.abs(j).max()), err
    jb, js = (np.asarray(a) for a in jax.jit(JY._decode_all)(jheads))
    pb, ps = (a.numpy() for a in PY._decode_all(pheads))
    np.testing.assert_allclose(pb, jb, rtol=BOX_RTOL, atol=BOX_ATOL)
    np.testing.assert_allclose(ps, js, rtol=0, atol=BOX_ATOL)
    # the same NMS on the same boxes, and a non-trivial one
    sel = js > 0.05
    keep = PY._nms(jb[0][sel[0]] * PY.NET_SIZE, js[0][sel[0]])
    assert keep == JY._nms(jb[0][sel[0]] * JY.NET_SIZE, js[0][sel[0]])
    assert 1 < len(keep) < int(sel.sum())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_detections_and_person_bbox_match(detectors, seed):
    jd, pd = detectors
    rgb = _photo(seed, ((300, 220), (180, 260), (128, 128))[seed - 1])
    try:
        # at 0.3 the candidates' scores stand well apart, so the NMS order
        # (the scores') is the same in both packages
        jd.thresh = pd.thresh = 0.3
        (jb, js), (pb, ps) = jd(rgb), pd(rgb)
        assert np.diff(js).max() < -10 * BOX_ATOL
        assert len(pb) == len(jb) > 0
        np.testing.assert_allclose(pb, jb, rtol=BOX_RTOL, atol=1e-3)
        np.testing.assert_allclose(ps, js, rtol=0, atol=BOX_ATOL)
        box = PY.person_bbox(pd, rgb)
        assert box is not None and box == JY.person_bbox(jd, rgb)
        jd.thresh = pd.thresh = 1.0                           # nobody
        assert PY.person_bbox(pd, rgb) is None is JY.person_bbox(jd, rgb)
    finally:
        jd.thresh = pd.thresh = 0.25


def test_detect_and_matte_with_the_detector(detectors):
    """The detector's box (not the saliency box) bounds the matte, in both
    packages alike."""
    jd, pd = detectors
    rgb = _photo(4)
    seg = lambda crop: crop.mean(-1)                          # noqa: E731
    got = PD.detect_and_matte(rgb, seg, pd)
    np.testing.assert_allclose(got, JD.detect_and_matte(rgb, seg, jd),
                               rtol=0, atol=1e-6)
    y0, x0, y1, x1 = PY.person_bbox(pd, rgb)
    inside = np.zeros(got.shape, bool)
    inside[y0:y1, x0:x1] = True
    assert not got[~inside].any() and got[inside].min() > 0
    assert (y0, x0, y1, x1) != PD.saliency_person_bbox(rgb, thresh=0.35)


def test_the_frame_boxing_file_boxes_any_photo(tmp_path):
    """``write_demo_inputs``'s detector file: every photo gets the whole
    frame as its person box, in both packages."""
    path = str(tmp_path / "yolov3-tiny.weights")
    write_darknet_weights(path, np.random.RandomState(5), head="frame")
    jd, pd = JY.PersonDetector(path), PY.PersonDetector(path, device="cpu")
    for seed in (6, 7):
        rgb = _photo(seed, (200, 150))
        assert PY.person_bbox(pd, rgb) == JY.person_bbox(jd, rgb) == \
            (0, 0, 200, 150)


def test_truncated_or_padded_file_raises(tmp_path):
    path = tmp_path / "w"
    write_darknet_weights(str(path), np.random.RandomState(0))
    blob = path.read_bytes()
    for bad in (blob[:-4], blob + b"\0" * 8):
        with pytest.raises(ValueError):
            PY.parse_darknet_weights(bad)
