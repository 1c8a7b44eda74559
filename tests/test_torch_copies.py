"""The port's copies of framework-free code of the JAX package, pinned to
their originals: the config tree's field names and defaults, ``clean_mesh``,
the host lattice decoder, the synthetic body's arrays, the photo path's
host code (the saliency detector, ``process_image``, YOLO's darknet parser,
letterbox and NMS, the matting net's host pre- and post-processing), the
garment extraction, ``save_video``, ``get_smpl_model``, BEV's output
adaptation, ``process_image``'s raw crop, PaMIR's ``pamir_feats`` with
the tetrahedral SMPL loader, and the geometry trainer's host code:
``stable_hash``, ``HoppeSDF``, ``sample_points_with_labels`` (with the copy
of ``winding_np``), the fit loaders, the fixture writer's lighting and
config, ``point_error_image`` (``ray_parity_inside_np`` and ``winding_np``
are pinned in ``tests/test_torch_signs.py``, the fixture's files in
``tests/test_torch_train.py``); the renderer's ``fibonacci_sphere``, the
NormalNet trainer's ``normal_pred_panels``, the tetra builder's host
functions, the winding sign's ``build_winding_clusters`` and the indexed
marcher's ``dedup_triangle_soup``."""

import dataclasses
import pickle

import numpy as np
import pytest
import jax.numpy as jnp

from torch_port_helpers import port_cfg, t

import icon_tpu.config as JC
import icon_tpu_torch.config as PC
from icon_tpu import native
from icon_tpu.recon import marching as JM
from icon_tpu.utils import io as JIO
from icon_tpu.utils import synthetic as JS
from icon_tpu_torch.recon import lattice_host as PH
from icon_tpu_torch.recon import marching as PM
from icon_tpu_torch.utils import io as PIO
from icon_tpu_torch.utils import synthetic as PS


@pytest.mark.parametrize("name", ["Config", "NetConfig", "DatasetConfig"])
def test_config_fields_and_defaults(name):
    jc, pc = getattr(JC, name), getattr(PC, name)
    jf, pf = dataclasses.fields(jc), dataclasses.fields(pc)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())


def test_port_cfg_keeps_every_field():
    from icon_tpu_torch.recon.frame import bench_config
    cfg = port_cfg(JC.Config(net=JC.NetConfig(ngf=8, in_geo=(("a", 3),))))
    assert isinstance(cfg, PC.Config) and isinstance(cfg.net, PC.NetConfig)
    assert cfg.net.ngf == 8 and cfg.net.in_geo_dim == 3
    assert dataclasses.asdict(port_cfg(JC.Config())) == \
        dataclasses.asdict(PC.Config())
    assert isinstance(bench_config(), PC.Config)


def test_clean_mesh_matches():
    rng = np.random.RandomState(0)
    v, f = JS.synthetic_body(subdiv=2)
    # three components: the body, a shifted copy, and a lone triangle
    verts = np.concatenate([v, v + 3.0, rng.randn(3, 3).astype(np.float32)])
    faces = np.concatenate([f, f[:40] + len(v),
                            np.array([[0, 1, 2]]) + 2 * len(v)])
    for args in ((verts, faces), (v, f)):
        pv, pf = PIO.clean_mesh(*args)
        jv, jf = JIO.clean_mesh(*args)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pf, jf)
    assert len(PIO.clean_mesh(verts, faces)[0]) == len(v)


@pytest.mark.parametrize("implicit", [False, True])
def test_lattice_decoder_matches(implicit):
    """The port's g++-built decoder and the JAX package's native one give
    the same mesh of one packed lattice, vertex for vertex."""
    assert native.available()
    n = 33
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.6) ** 2) + \
        0.08 * np.sin(7 * x) * np.sin(5 * y)
    occ = (1.0 / (1.0 + np.exp((r - 0.8) * 12))).astype(np.float32)
    D, H, W = occ.shape
    lat = PM.marching_lattice(t(occ), max_cells=1 << 14, max_verts=1 << 15)
    buf, nvb, ncb = PM.pack_lattice(lat, implicit_eid=implicit)
    host = buf.numpy()
    pv, pf, pinfo = PH.lattice_decode(host, nvb, ncb, H, W, implicit)
    jv, jf, jinfo = native.lattice_decode(
        host, nvb, ncb, H, W, *JM._host_tables_flat(), implicit=implicit)
    assert len(pf) > 1000
    np.testing.assert_array_equal(pinfo, jinfo)
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pv, jv)
    dv, df = PH.decode_lattice((buf, nvb, ncb), H, W)
    np.testing.assert_array_equal(df, jf.astype(np.int64))


def test_lattice_decoder_rejects_malformed_sizes():
    with pytest.raises(ValueError, match="malformed"):
        PH.lattice_decode(np.zeros(4, np.int32), 0, 4, 8, 8, False)


@pytest.mark.parametrize("subdiv", [0, 2, 3])
def test_synthetic_body_arrays_match(subdiv):
    for a, b in zip(PS.synthetic_body(subdiv), JS.synthetic_body(subdiv)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PS.icosphere(subdiv, 0.7), JS.icosphere(subdiv, 0.7)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_skeleton_matches():
    rng = np.random.RandomState(1)
    for pose in (None, (rng.randn(24, 3) * 0.3).astype(np.float32)):
        pj, jj = PS.posed_skeleton(pose), JS.posed_skeleton(pose)
        np.testing.assert_array_equal(pj, jj)
        for a, b in zip(PS._capsule_segments(pj), JS._capsule_segments(jj)):
            np.testing.assert_array_equal(a, b)
    for name in ("SMPL_PARENTS", "REST_JOINTS", "THUMAN2_0525_POSE"):
        np.testing.assert_array_equal(getattr(PS, name), getattr(JS, name))
    assert PS.BONE_CAPSULES == JS.BONE_CAPSULES
    # the torch field on the copied skeleton equals the JAX field
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    np.testing.assert_allclose(
        PS.clothed_human_occ(t(pts)).numpy(),
        np.asarray(JS.clothed_human_occ(jnp.asarray(pts))), atol=1e-5)


# -- the demo's photo path: io, config, calib, detector, crop, assets -------

def test_save_and_load_obj_match(tmp_path):
    """Identical file bytes with and without colours; the same arrays read
    back, polygons fan-triangulated."""
    rng = np.random.RandomState(2)
    v = rng.randn(40, 3).astype(np.float32)
    f = rng.randint(0, 40, (60, 3))
    c = rng.rand(40, 3).astype(np.float32)
    for colors in (None, c):
        PIO.save_obj(str(tmp_path / "p.obj"), v, f, colors)
        JIO.save_obj(str(tmp_path / "j.obj"), v, f, colors)
        assert (tmp_path / "p.obj").read_bytes() == \
            (tmp_path / "j.obj").read_bytes()
    with open(tmp_path / "quad.obj", "a") as fh:
        fh.write("f 1/1 2/2 3/3 4/4\n")
    for a, b in zip(PIO.load_obj(str(tmp_path / "quad.obj")),
                    JIO.load_obj(str(tmp_path / "quad.obj"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_save_gif_matches(tmp_path):
    rng = np.random.RandomState(3)
    frames = [(rng.rand(16, 48, 3) * 255).astype(np.uint8) for _ in range(3)]
    PIO.save_gif(str(tmp_path / "p.gif"), frames, fps=2)
    JIO.save_gif(str(tmp_path / "j.gif"), frames, fps=2)
    assert (tmp_path / "p.gif").read_bytes() == \
        (tmp_path / "j.gif").read_bytes()


def test_load_config_matches(tmp_path):
    """The reference's YAML style (channel specs as python-literal strings,
    lists for tuples, unknown legacy keys) and a yacs override list give
    equal trees in both packages."""
    text = """
name: icon-filter
mcube_res: 128
clean_mesh: False
test_gpus: [0]
net:
  mlp_dim: [256, 512, 256, 128, 1]
  res_layers: [2, 3, 4]
  num_stack: 2
  prior_type: icon
  in_geo: (('normal_F',3), ('normal_B',3))
  in_nml: (('image',3), ('T_normal_F',3), ('T_normal_B',3))
  smpl_feats: ['sdf', 'norm', 'vis', 'cmap']
  smpl_dim: 7
  norm_mlp: batch
dataset:
  scales: [100.0]
"""
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    over = ["net.hourglass_dim", "6", "batch_size", "2", "net.norm", "batch"]
    for args in ((str(path),), (str(path), over), (None, over)):
        pc, jc = PC.load_config(*args), JC.load_config(*args)
        assert isinstance(pc, PC.Config)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert PC.load_config(str(path)).net.in_geo_dim == 6
    assert dataclasses.asdict(PC.get_cfg_defaults()) == \
        dataclasses.asdict(JC.get_cfg_defaults())
    with pytest.raises(ValueError, match="alternate"):
        PC.load_config(None, ["mcube_res"])


def test_make_calib_matches():
    from icon_tpu.data.render_dataset import make_calib as jcalib
    from icon_tpu_torch.data.render_dataset import make_calib as pcalib
    for az, s in ((0.0, 1.0), (90.0, 1.0), (217.5, 0.8)):
        a, b = pcalib(az, s), jcalib(az, s)
        assert a.dtype == b.dtype and a.shape == (8, 4)
        np.testing.assert_array_equal(a, b)


def _photo(rng, size=(120, 90)):
    """A textured background with a brighter noisy figure in it."""
    H, W = size
    img = np.clip(0.4 + 0.05 * rng.randn(H, W, 3), 0, 1)
    yy, xx = np.mgrid[:H, :W]
    fig = ((yy - 0.55 * H) ** 2 / (0.35 * H) ** 2 +
           (xx - 0.45 * W) ** 2 / (0.18 * W) ** 2) < 1
    img[fig] = rng.rand(int(fig.sum()), 3)
    return img.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_matches(seed):
    from icon_tpu.models import detector as JD
    from icon_tpu_torch.models import detector as PD
    rgb = _photo(np.random.RandomState(seed))
    assert PD.saliency_person_bbox(rgb) == JD.saliency_person_bbox(rgb)
    assert PD.saliency_person_bbox(rgb, thresh=0.35) == \
        JD.saliency_person_bbox(rgb, thresh=0.35)
    np.testing.assert_allclose(PD.spectral_residual_saliency(rgb),
                               JD.spectral_residual_saliency(rgb),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(PD.border_contrast_saliency(rgb),
                               JD.border_contrast_saliency(rgb),
                               rtol=0, atol=1e-6)
    with pytest.warns(UserWarning, match="matting"):
        pa = PD.detect_and_matte(rgb)
    with pytest.warns(UserWarning, match="matting"):
        ja = JD.detect_and_matte(rgb)
    assert pa.max() > 0
    np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-6)
    seg = lambda crop: crop.mean(-1)                          # noqa: E731
    np.testing.assert_allclose(PD.detect_and_matte(rgb, seg),
                               JD.detect_and_matte(rgb, seg), rtol=0,
                               atol=1e-6)
    # a detector's box (here a stub's best box, with the 10% margin of
    # person_bbox) bounds the matte in both packages; nobody found: the
    # saliency box
    for boxes in ([[10.0, 12.5, 60.0, 41.0], [0.0, 0.0, 5.0, 5.0]], []):
        det = lambda im, b=boxes: (np.asarray(b, np.float32).reshape(-1, 4),
                                   np.ones(len(b), np.float32))  # noqa: E731
        np.testing.assert_array_equal(
            PD.detect_and_matte(rgb, seg, det),
            JD.detect_and_matte(rgb, seg, det))


def test_alpha_bbox_matches():
    from icon_tpu.data.test_dataset import alpha_bbox as jbox
    from icon_tpu_torch.data.test_dataset import alpha_bbox as pbox
    rng = np.random.RandomState(4)
    for shape in ((50, 80), (80, 50), (64, 64)):
        empty = np.zeros(shape, np.float32)
        assert pbox(empty) == jbox(empty)
        for _ in range(5):
            a = np.zeros(shape, np.float32)
            y0, x0 = rng.randint(0, shape[0] - 5), rng.randint(0, shape[1] - 5)
            a[y0:y0 + rng.randint(2, 40), x0:x0 + rng.randint(2, 40)] = 1.0
            for margin in (0.1, 0.3):
                assert pbox(a, margin=margin) == jbox(a, margin=margin)


@pytest.mark.parametrize("mode", ["RGBA", "RGB"])
def test_process_image_is_byte_equal(tmp_path, mode):
    """The port's crop, resize and normalization of a PNG the test writes
    equal the JAX package's byte for byte (PIL's uint8 bilinear resize,
    the clip * 255 -> uint8 round trip), crop_param included."""
    import warnings
    from PIL import Image
    from icon_tpu.data.test_dataset import process_image as jproc
    from icon_tpu_torch.data.test_dataset import process_image as pproc
    rng = np.random.RandomState(5)
    rgb = (_photo(rng, (130, 100)) * 255).astype(np.uint8)
    if mode == "RGBA":
        alpha = np.zeros(rgb.shape[:2], np.uint8)
        alpha[20:120, 30:70] = 255
        Image.fromarray(np.concatenate([rgb, alpha[..., None]], -1)).save(
            tmp_path / "x.png")
    else:
        Image.fromarray(rgb).save(tmp_path / "x.png")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = pproc(str(tmp_path / "x.png"), icon_size=96)
        want = jproc(str(tmp_path / "x.png"), icon_size=96)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[3] == want[3]
    assert got[2].sum() > 100


def test_synthetic_smpl24_matches():
    from icon_tpu.models.pymaf.net import _synthetic_smpl24 as jmodel
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24 as pmodel
    for subdiv in (2, 4):
        p, j = pmodel(subdiv), jmodel(subdiv)
        for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                     "lbs_weights"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(j, name)), name)
        np.testing.assert_array_equal(p.faces, np.asarray(j.faces))
        assert p.parents == tuple(j.parents) and p.num_joints == 24
        assert (p.model_type, p.num_betas) == (j.model_type, j.num_betas)


def write_cmap_assets(root, n_smpl: int, rng) -> None:
    """Seeded ``smplx_verts.npy``, ``smpl_verts.npy`` (``n_smpl`` verts)
    and ``smplx_cmap.npy`` under ``root/smpl_related/smpl_data``."""
    sd = root / "smpl_related" / "smpl_data"
    sd.mkdir(parents=True, exist_ok=True)
    np.save(sd / "smplx_verts.npy", rng.randn(300, 3).astype(np.float32))
    np.save(sd / "smpl_verts.npy", rng.randn(n_smpl, 3).astype(np.float32))
    np.save(sd / "smplx_cmap.npy", rng.rand(300, 3))


def test_smplx_registry_matches(tmp_path, monkeypatch):
    from icon_tpu.models.smplx import assets as JA
    from icon_tpu_torch.models.smplx import assets as PA
    assert PA.data_root() == JA.data_root()
    write_cmap_assets(tmp_path, 120, np.random.RandomState(6))
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    assert PA.data_root() == JA.data_root() == str(tmp_path)
    p, j = PA.SMPLX(), JA.SMPLX()
    for name in ("smpl_verts_path", "smplx_verts_path", "faces_path",
                 "cmap_vert_path", "model_dir", "tedra_dir"):
        assert getattr(p, name) == getattr(j, name)
    for kind in ("smplx", "smpl"):
        a, b = p.cmap_smpl_vids(kind), j.cmap_smpl_vids(kind)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert p.cmap_smpl_vids("smpl").shape == (120, 3)


def test_export_overlap_is_byte_equal(tmp_path):
    """The CLI's ``_overlap.png`` panel against the JAX CLI's
    ``_export_overlap`` on seeded inputs (values beyond [-1, 1] clipped, a
    soft mask thresholded): identical file bytes."""
    from icon_tpu.apps.infer import _export_overlap
    from icon_tpu_torch.apps.infer import export_overlap
    rng = np.random.RandomState(5)
    image, nml = rng.uniform(-1.2, 1.2, (2, 48, 40, 3)).astype(np.float32)
    mask = rng.rand(48, 40).astype(np.float32)
    _export_overlap(str(tmp_path / "jax.png"), image, nml, mask)
    export_overlap(str(tmp_path / "port.png"), image, nml, mask)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()


def test_darknet_parser_matches(tmp_path):
    """One seeded darknet file of each header version: every array equal,
    and the BatchNorm fold equal to the JAX package's (its kernels in the
    torch layout)."""
    import struct
    from icon_tpu.models import yolo as JY
    from icon_tpu_torch.models import yolo as PY
    from icon_tpu_torch.utils.synthetic import write_darknet_weights
    write_darknet_weights(str(tmp_path / "w"), np.random.RandomState(8))
    blob = (tmp_path / "w").read_bytes()
    # version 0.1: the images seen as int32
    old = struct.pack("<iiii", 0, 1, 0, 0) + blob[20:]
    for b in (blob, old):
        p, j = PY.parse_darknet_weights(b), JY.parse_darknet_weights(b)
        assert list(p) == list(j)
        for name in j:
            assert list(p[name]) == list(j[name])
            for k in j[name]:
                assert p[name][k].tobytes() == j[name][k].tobytes()
    folded, params = PY.fold_to_params(p), JY.fold_to_params(j)
    for name, d in params.items():
        np.testing.assert_array_equal(
            folded[f"{name}.weight"].numpy().transpose(2, 3, 1, 0),
            d["kernel"])
        np.testing.assert_array_equal(folded[f"{name}.bias"].numpy(),
                                      d["bias"])


@pytest.mark.parametrize("hw", [(300, 200), (120, 416), (417, 90)])
def test_letterbox_matches(hw):
    from icon_tpu.models import yolo as JY
    from icon_tpu_torch.models import yolo as PY
    rgb = np.random.RandomState(hw[0]).uniform(-0.1, 1.1, (*hw, 3))
    p, j = PY._letterbox(rgb), JY._letterbox(rgb)
    assert p[0].dtype == j[0].dtype and p[0].tobytes() == j[0].tobytes()
    assert p[1:] == j[1:]


def test_nms_matches():
    from icon_tpu.models import yolo as JY
    from icon_tpu_torch.models import yolo as PY
    rng = np.random.RandomState(9)
    for n in (1, 2, 40, 300):
        boxes = np.concatenate([rng.uniform(50, 350, (n, 2)),
                                rng.uniform(5, 120, (n, 2))], 1).astype(
            np.float32)
        scores = rng.rand(n).astype(np.float32)
        for iou in (0.45, 0.1):
            keep = PY._nms(boxes, scores, iou)
            assert keep == JY._nms(boxes, scores, iou)
    assert 1 < len(keep) < n


def test_segmenter_host_code_matches():
    """The matting's host side, bit for bit: the JAX segmenter's closure
    runs with its net replaced by a recorder that returns a seeded alpha;
    the port's ``segmenter_input`` equals what the net was given and its
    ``segmenter_output`` equals the JAX segmenter's result."""
    from icon_tpu.models import u2net as JU
    from icon_tpu_torch.models import u2net as PU
    segment = JU.build_segmenter("", lite=True)
    cells = dict(zip(segment.__code__.co_freevars, segment.__closure__))
    seen = []
    rng = np.random.RandomState(10)
    alpha = rng.rand(1, 320, 320, 1).astype(np.float32)

    def fwd(variables, x):
        seen.append(np.asarray(x))
        return alpha

    cells["fwd"].cell_contents = fwd
    for hw in ((150, 97), (320, 320), (41, 500)):
        rgb = rng.uniform(-0.05, 1.05, (*hw, 3)).astype(np.float32)
        want = segment(rgb)
        x = PU.segmenter_input(rgb)
        assert x.dtype == seen[-1].dtype
        assert x[None].tobytes() == seen[-1].tobytes()
        got = PU.segmenter_output(alpha[0, ..., 0], hw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _mesh_and_segs(rng):
    v, f = JS.synthetic_body(subdiv=3)
    v = v * 0.9 + 0.01 * rng.randn(*v.shape).astype(np.float32)
    # a second component, so that the largest one is picked
    f = np.concatenate([f, f + len(v)])
    v = np.concatenate([v, v * 0.2 + 0.6]).astype(np.float32)
    segs = [{"type": "upper", "coordinates": [[60, 60, 460, 60, 460, 250,
                                               60, 250]]},
            {"type": "dress", "coord": [[100, 200, 420, 200, 256, 500],
                                        [400, 20, 500, 20, 500, 120]]},
            {"type": "none", "coordinates": [[0, 0, 2, 0, 2, 2]]},
            {"type": "open", "coordinates": [[10, 10, 20, 20]]},
            {"type": "missing"}]
    return v, f, segs


def test_cloth_extraction_matches():
    from icon_tpu.ops import cloth_extraction as JC
    from icon_tpu_torch.ops import cloth_extraction as PC
    rng = np.random.RandomState(11)
    v, f, segs = _mesh_and_segs(rng)
    px, py = PC.project_to_pixels(v)
    jx, jy = JC.project_to_pixels(v)
    assert px.tobytes() == jx.tobytes() and py.tobytes() == jy.tobytes()
    poly = np.array([[50, 40], [300, 80], [200, 400], [90, 300]], np.float32)
    np.testing.assert_array_equal(PC.point_in_polygon(px, py, poly),
                                  JC.point_in_polygon(jx, jy, poly))
    np.testing.assert_array_equal(PC.largest_component(f, len(v)),
                                  JC.largest_component(f, len(v)))
    n_cut = 0
    for seg in segs:
        for size in (512, 256):
            p = PC.extract_cloth(v, f, seg, image_size=size)
            j = JC.extract_cloth(v, f, seg, image_size=size)
            assert (p is None) == (j is None), seg["type"]
            if p is not None:
                n_cut += 1
                for a, b in zip(p, j):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert n_cut >= 3
    parts = {"a": list(range(0, 300)), "b": list(range(300, 642))}
    p = PC.smpl_to_recon_labels(v[::3], v[:642], parts)
    j = JC.smpl_to_recon_labels(v[::3], v[:642], parts)
    assert list(p) == list(j)
    for k in j:
        np.testing.assert_array_equal(p[k], j[k])


def test_save_video_matches(tmp_path, monkeypatch):
    """``save_video`` hands OpenCV the same calls (path, fourcc, fps,
    size, the BGR frames) as the JAX package's."""
    import cv2
    rng = np.random.RandomState(12)
    frames = [rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)
              for _ in range(3)]
    calls = {}

    class Writer:
        def __init__(self, *args):
            self.log = calls.setdefault(args[0], [args[1:]])

        def write(self, fr):
            self.log.append(fr.tobytes())

        def release(self):
            self.log.append("release")

    monkeypatch.setattr(cv2, "VideoWriter", Writer)
    PIO.save_video(str(tmp_path / "p" / "a.mp4"), frames, fps=12)
    JIO.save_video(str(tmp_path / "j" / "a.mp4"), frames, fps=12)
    p, j = calls[str(tmp_path / "p" / "a.mp4")], \
        calls[str(tmp_path / "j" / "a.mp4")]
    assert p == j and len(p) == 5 and p[-1] == "release"


def test_get_smpl_model_matches(tmp_path, monkeypatch):
    """``get_smpl_model``: without the licensed files both packages give
    the synthetic SMPL-X stand-in (subdiv 4), array for array; with a
    model file installed both pick the same file (npz before pkl) and
    model type."""
    from icon_tpu.models.smplx import assets as JA
    from icon_tpu.models.smplx import body as JB
    from icon_tpu_torch.models.smplx import assets as PA
    from icon_tpu_torch.models.smplx import body as PB
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    p = PA.get_smpl_model("smplx", "neutral")
    j = JA.get_smpl_model.__wrapped__("smplx", "neutral")
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "lbs_weights", "expr_dirs", "hands_components_l",
                 "hands_mean_l", "hands_mean_r"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    np.testing.assert_array_equal(p.faces, np.asarray(j.faces))
    assert p.parents == tuple(j.parents) and p.model_type == "smplx"
    assert p is not PA.get_smpl_model("smplx", "neutral")   # no cache
    mdir = tmp_path / "smpl_related" / "models" / "smplx"
    mdir.mkdir(parents=True)
    calls = []
    for mod in (JB, PB):
        monkeypatch.setattr(mod, "load_body_model",
                            lambda path, model_type=None: calls.append(
                                (path, model_type)))
    for ext in ("pkl", "npz"):
        (mdir / f"SMPLX_NEUTRAL.{ext}").write_bytes(b"")
        PA.get_smpl_model("smplx", "neutral")
        JA.get_smpl_model.__wrapped__("smplx", "neutral")
        assert calls[-1] == calls[-2] == (
            str(mdir / f"SMPLX_NEUTRAL.{ext}"), "smplx")


def test_bev_adapter_matches():
    """``_rodrigues_np`` and ``adapt_bev_output`` on seeded BEV outputs
    (two people, 11 betas): identical arrays."""
    from icon_tpu.data import test_dataset as JD
    from icon_tpu_torch.data import test_dataset as PD
    rng = np.random.RandomState(9)
    aa = np.concatenate([np.zeros((1, 3)), rng.randn(15, 3)]).astype(
        np.float32)
    np.testing.assert_array_equal(PD._rodrigues_np(aa), JD._rodrigues_np(aa))
    preds = {"smpl_thetas": rng.randn(2, 72).astype(np.float32),
             "smpl_betas": rng.randn(2, 11).astype(np.float32),
             "verts": rng.randn(2, 6890, 3).astype(np.float32),
             "cam": rng.randn(2, 3).astype(np.float32),
             "cam_trans": rng.randn(2, 3).astype(np.float32)}
    got, want = PD.adapt_bev_output(preds), JD.adapt_bev_output(preds)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("mode", ["RGBA", "RGB"])
def test_process_image_raw_crop_is_byte_equal(tmp_path, mode):
    """``process_image(..., return_raw=True)`` (BEV's input): the fifth
    entry, the unmasked crop as uint8, equals the JAX package's byte for
    byte; the first four are those without it."""
    import warnings
    from PIL import Image
    from icon_tpu.data.test_dataset import process_image as jproc
    from icon_tpu_torch.data.test_dataset import process_image as pproc
    rgb = (_photo(np.random.RandomState(10), (90, 120)) * 255).astype(
        np.uint8)
    im = Image.fromarray(rgb)
    if mode == "RGBA":
        alpha = np.zeros(rgb.shape[:2], np.uint8)
        alpha[10:80, 40:90] = 255
        im = Image.fromarray(np.concatenate([rgb, alpha[..., None]], -1))
    im.save(tmp_path / "x.png")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = pproc(str(tmp_path / "x.png"), icon_size=64, return_raw=True)
        want = jproc(str(tmp_path / "x.png"), icon_size=64, return_raw=True)
        plain = pproc(str(tmp_path / "x.png"), icon_size=64)
    assert len(got) == len(want) == 5
    assert got[4].dtype == want[4].dtype == np.uint8
    assert got[4].shape == (64, 64, 3)
    assert got[4].tobytes() == want[4].tobytes()
    for g, p in zip(got[:3], plain[:3]):
        assert g.tobytes() == p.tobytes()


def _write_tetra_assets(root, body, n_added: int, rng):
    """A seeded SMPL release pickle of ``body``'s arrays (the JAX synthetic
    SMPL) and a tetra npz of ``n_added`` interior vertices, where the demo
    looks for them."""
    v = np.asarray(body.v_template)
    V, J = len(v), len(body.parents)
    posedirs = np.asarray(body.posedirs).T.reshape(V, 3, -1)
    models = root / "smpl_related" / "models" / "smpl"
    models.mkdir(parents=True)
    kintree = np.stack([np.asarray(body.parents), np.arange(J)])
    kintree[0, 0] = 4294967295
    with open(models / "SMPL_MALE.pkl", "wb") as f:
        pickle.dump({"v_template": v, "shapedirs": np.asarray(body.shapedirs),
                     "posedirs": posedirs,
                     "J_regressor": np.asarray(body.J_regressor),
                     "weights": np.asarray(body.lbs_weights),
                     "kintree_table": kintree,
                     "f": np.asarray(body.faces)}, f)
    tedra = root / "tedra_data"
    tedra.mkdir()
    w = rng.rand(n_added, J)
    np.savez(tedra / "tetra_male_adult_smpl.npz",
             v_template_added=(0.5 * rng.randn(n_added, 3)).astype(
                 np.float32),
             shapedirs_added=(0.01 * rng.randn(n_added, 3, 10)),
             posedirs_added=(0.01 * rng.randn(n_added, 3,
                                              posedirs.shape[-1])),
             weights_added=w / w.sum(1, keepdims=True),
             tetrahedrons=rng.randint(0, V, (20, 4)))


@pytest.mark.parametrize("installed", [True, False])
def test_pamir_feats_match(tmp_path, monkeypatch, installed):
    """The demo's voxel inputs against the JAX CLI's ``_pamir_feats`` on
    one fit: with the tetra assets written by the test (the loader's
    arrays equal the JAX loader's; the tetra body posed on the host with
    the fit's rotation matrices), and without them (the fitted surface);
    padded to 8,000 vertices, projected and halved."""
    from icon_tpu.apps.infer import _pamir_feats
    from icon_tpu.models.pymaf.net import _synthetic_smpl24
    from icon_tpu.models.smplx.lbs import batch_rodrigues
    from icon_tpu.models.smplx.tetra import load_tetra_body_model as jload
    from icon_tpu_torch.models.smplx.tetra import load_tetra_body_model
    from icon_tpu_torch.recon.frame import load_tetra, pamir_feats
    from icon_tpu_torch.utils.convert import body_model_from_jax
    jbody = _synthetic_smpl24(subdiv=2)
    rng = np.random.RandomState(11)
    if installed:
        _write_tetra_assets(tmp_path, jbody, 150, rng)
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    rot = np.asarray(batch_rodrigues(jnp.asarray(
        0.2 * rng.randn(24, 3).astype(np.float32))))
    params = {"betas": (0.5 * rng.randn(1, 10)).astype(np.float32),
              "body_pose": rot[None, 1:], "global_orient": rot[None, :1],
              "trans": (0.05 * rng.randn(3)).astype(np.float32)}
    scale = 0.9
    verts = np.asarray(jbody.v_template) * 0.8
    calib = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    want = _pamir_feats(jnp.asarray(verts), jbody, params, scale, calib)
    tetra = load_tetra()
    assert (tetra is None) == (not installed)
    got = pamir_feats(t(verts), body_model_from_jax(jbody),
                      {k: t(v) for k, v in params.items()}, scale,
                      t(calib), tetra)
    assert got["voxel_verts"].shape == (1, 8000, 3)
    assert got["voxel_codes"].shape == (8000, 3)
    np.testing.assert_allclose(got["voxel_verts"].numpy(),
                               np.asarray(want["voxel_verts"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["voxel_codes"].numpy(),
                                  np.asarray(want["voxel_codes"]))
    if installed:
        root = tmp_path / "smpl_related"
        args = (str(root / "models" / "smpl" / "SMPL_MALE.pkl"),
                str(tmp_path / "tedra_data" / "tetra_male_adult_smpl.npz"))
        pm, pe = load_tetra_body_model(*args)
        jm, je = jload(*args)
        for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                     "lbs_weights"):
            np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                          np.asarray(getattr(jm, name)))
        assert pm.parents == tuple(jm.parents) and pe["n_surface"] == \
            je["n_surface"] == len(verts)
        np.testing.assert_array_equal(pe["tetrahedrons"],
                                      je["tetrahedrons"])


# -- the geometry trainer's host code -----------------------------------------

def _scan(rng):
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    model = synthetic_smplx_model(subdiv=2)
    v = model.v_template.numpy() + 0.01 * rng.randn(
        *model.v_template.shape).astype(np.float32)
    return v.astype(np.float32), np.asarray(model.faces, np.int64)


def test_stable_hash_and_host_geometry_match():
    from icon_tpu.data import datasets as JD
    from icon_tpu_torch.data import datasets as PD
    for text in ("synth/0000_0", "thuman2/0525_120", ""):
        assert PD.stable_hash(text) == JD.stable_hash(text)
    assert PD.SHARED_KEYS == JD.SHARED_KEYS
    assert PD.NOISE_SMPLX_IDX == JD.NOISE_SMPLX_IDX
    rng = np.random.RandomState(3)
    v, f = _scan(rng)
    np.testing.assert_array_equal(PD.vertex_normals_np(v, f),
                                  JD.vertex_normals_np(v, f))
    calib = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    np.testing.assert_array_equal(PD.projection_np(v, calib),
                                  JD.projection_np(v, calib))
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(PD.HoppeSDF(v, f).query(pts),
                                  JD.HoppeSDF(v, f).query(pts))
    np.testing.assert_array_equal(PD.HoppeSDF(v, f).contains(pts),
                                  JD.HoppeSDF(v, f).contains(pts))


@pytest.mark.parametrize("use_sdf", [False, True])
def test_sample_points_with_labels_matches(use_sdf):
    """The same samples and labels (the winding labels through the port's
    copy of ``winding_np``)."""
    from icon_tpu.data import datasets as JD
    from icon_tpu_torch.data import datasets as PD
    v, f = _scan(np.random.RandomState(4))
    calib = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    for seed in (0, 7):
        a = PD.sample_points_with_labels(v, f, calib, 256, 0.05, seed=seed,
                                         use_sdf=use_sdf)
        b = JD.sample_points_with_labels(v, f, calib, 256, 0.05, seed=seed,
                                         use_sdf=use_sdf)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_fit_param_loader_and_body_match(tmp_path):
    """``load_smplx_param`` and ``load_fit_body`` on one fit pickle: the
    same parameters, the same body to 1e-5 (the body models' float32 sums
    in another order)."""
    from icon_tpu.models.smplx import assets as JA
    from icon_tpu_torch.models.smplx import assets as PA
    rng = np.random.RandomState(5)
    param = {"betas": rng.randn(1, 10).astype(np.float32) * 0.3,
             "global_orient": rng.randn(1, 3).astype(np.float32) * 0.1,
             "body_pose": rng.randn(1, 63).astype(np.float32) * 0.1,
             "scale": np.float64(1.3), "translation": np.ones(3) * 0.1}
    path = tmp_path / "smplx_param.pkl"
    with open(path, "wb") as fh:
        pickle.dump(param, fh)
    a, b = PA.load_smplx_param(str(path)), JA.load_smplx_param(str(path))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for got, want in zip(PA.load_fit_body(str(path), 2.0),
                         JA.load_fit_body(str(path), 2.0)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_helpers_and_fixture_config_match():
    """The SH lighting of the renders and the fixture's config."""
    from icon_tpu.data import fixture as JF
    from icon_tpu.data import render_dataset as JR
    from icon_tpu_torch.data import fixture as PF
    from icon_tpu_torch.data import render_dataset as PR
    rng = np.random.RandomState(6)
    n = rng.randn(50, 3).astype(np.float32)
    np.testing.assert_array_equal(PR.sh_basis(n), JR.sh_basis(n))
    np.testing.assert_array_equal(PR.random_sh(np.random.RandomState(1)),
                                  JR.random_sh(np.random.RandomState(1)))
    for prior in ("icon", "pamir"):
        assert dataclasses.asdict(PF.fixture_config("/r", prior_type=prior)) \
            == dataclasses.asdict(JF.fixture_config("/r", prior_type=prior))


def test_point_error_image_matches():
    from icon_tpu.training.visuals import point_error_image as jimg
    from icon_tpu_torch.training.visuals import point_error_image as pimg
    rng = np.random.RandomState(7)
    xy = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    pred, lab = rng.rand(300, 1), (rng.rand(300) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(pimg(xy, pred, lab, 64),
                                  jimg(xy, pred, lab, 64))


# -- the dataset renderer's, the NormalNet trainer's and the tetra builder's

@pytest.mark.parametrize("n", [1, 16, 64, 101])
def test_fibonacci_sphere_matches(n):
    from icon_tpu.data.render_dataset import fibonacci_sphere as jfib
    from icon_tpu_torch.data.render_dataset import fibonacci_sphere
    got = fibonacci_sphere(n)
    assert got.dtype == np.float32 and got.shape == (n, 3)
    np.testing.assert_array_equal(got, jfib(n))


def test_normal_pred_panels_copy_matches():
    from icon_tpu.training.visuals import normal_pred_panels as jpanels
    from icon_tpu_torch.training.visuals import normal_pred_panels
    rng = np.random.RandomState(8)
    keys = ("image", "T_normal_F", "normal_F", "normal_B")
    batch = {k: rng.randn(3, 4, 4, 3).astype(np.float32) for k in keys}
    pred = rng.randn(3, 4, 4, 3).astype(np.float32)
    for pred_b in (None, -pred):
        want = jpanels(batch, pred, pred_b)
        got = normal_pred_panels(batch, pred, pred_b)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_tetrahedronize_host_functions_match():
    """``interior_nodes``, ``tetrahedralize``, ``transfer_weights`` and
    ``build_tetra_npz`` on the synthetic body at subdiv 2, with seeded
    blend directions."""
    from icon_tpu.apps import tetrahedronize as J
    from icon_tpu_torch.apps import tetrahedronize as P
    v, f = JS.synthetic_body(subdiv=2)
    rng = np.random.RandomState(9)
    np.testing.assert_array_equal(P.interior_nodes(v, f, 0.05),
                                  J.interior_nodes(v, f, 0.05))
    for a, b in zip(P.tetrahedralize(v, f), J.tetrahedralize(v, f)):
        np.testing.assert_array_equal(a, b)
    w = rng.rand(len(v), 5).astype(np.float32)
    sd = rng.randn(len(v), 3, 4).astype(np.float32)
    pd = rng.randn(len(v), 3, 6).astype(np.float32)
    added = P.interior_nodes(v, f, 0.05)
    for a, b in zip(P.transfer_weights(added, v, w, sd, pd),
                    J.transfer_weights(added, v, w, sd, pd)):
        np.testing.assert_array_equal(a, b)
    got, want = P.build_tetra_npz(v, f, w, sd, pd), \
        J.build_tetra_npz(v, f, w, sd, pd)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_winding_clusters_and_soup_dedup_match(seed):
    """The host copies of ``build_winding_clusters`` (the balanced k-d
    face clusters of the winding sign, on a scan-like mesh with a ragged
    last cluster) and ``dedup_triangle_soup``: identical arrays."""
    from icon_tpu.ops import sdf_fast as JF
    from icon_tpu_torch.ops import sdf_fast as PF
    rng = np.random.RandomState(seed)
    v, f = _scan(rng)
    f = f[:len(f) - 5]
    for n_clusters in (256, 60):
        for a, b in zip(PF.build_winding_clusters(v, f, n_clusters),
                        JF.build_winding_clusters(v, f, n_clusters)):
            np.testing.assert_array_equal(a, b)
    tri = v[f][:200].astype(np.float32)
    mask = rng.rand(200) > 0.2
    for a, b in zip(PM.dedup_triangle_soup(tri, mask),
                    JM.dedup_triangle_soup(tri, mask)):
        np.testing.assert_array_equal(a, b)
