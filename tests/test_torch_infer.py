"""The port's demo CLI (``icon_tpu_torch.apps.infer.main``) on the CPU at
64^2, ``-mcube_res 64``, two fit and one cloth iteration, on an RGBA and
an RGB photo the test writes, with seeded reference-layout ``.ckpt`` files
(the MLP's last layer reads the body's signed distance, ``sdf_readout``,
so the recon is body-shaped and small) and PyMAF's seeded random weights:

- the JAX CLI's artifact set (``tests/test_infer_e2e.py:57-67``) and the
  later stages' meshes;
- the ``-loop_smpl 0`` branch with a ``<name>_smpl.npz`` override: the
  written body is the override's, to 1e-5;
- the checkpoint load rules against the JAX package's
  ``port_icon_checkpoint`` on the same files: every tensor equal;
- each refused flag raises, naming its ROADMAP item; ``-export_video``
  and ``-seg_dir`` (A7 (rest), now ported) run and write ``_cloth.mp4``
  (read back with cv2, the turntable's frame count patched down to 4) and
  the garment OBJs of a seeded polygon JSON; ``-hps_type pixie`` (A8
  (rest), now ported) runs with a seeded published-width
  ``pixie_model.tar`` and fits the SMPL-X body;
- the pifu and pamir priors (A9) through the CLI on the scene photo with
  their own seeded checkpoints (``prior_readout``): pifu without the fit
  or its artifacts, pamir with the body's volume once a photo.

The JAX CLI itself is a slow test (``tests/test_infer_e2e.py``)."""

import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import normalnet_cfg, port_cfg

SIZE, RES = 64, 64
ARTIFACTS = ("_smpl.obj", "_smpl.npy", "_smpl.gif", "_overlap.png",
             "_recon.obj", "_refine.obj", "_recon_color.obj")


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """(in_dir, cfg.yaml, geometry .ckpt, normal .ckpt, the port's config
    and the state the files hold)."""
    from icon_tpu_torch.recon.frame import seeded_state
    from icon_tpu_torch.utils.synthetic import sdf_readout, write_demo_inputs
    cfg = port_cfg(normalnet_cfg())
    paths = write_demo_inputs(str(tmp_path_factory.mktemp("demo")), cfg,
                              photo_size=96, subdiv=2, seed=3)
    # entries of the published geometry file that the loader drops
    geo = torch.load(paths["ckpt"], weights_only=False)
    geo["state_dict"].update({
        "netG.normal_filter.netF.model.1.weight": torch.zeros(1),
        "netG.reconEngine.grid": torch.zeros(1), "epoch": 3})
    torch.save(geo, paths["ckpt"])
    state = sdf_readout(cfg, seeded_state(cfg, 3, normal_net=True))
    return (paths["in_dir"], paths["cfg"], paths["ckpt"],
            paths["normal_ckpt"], cfg, state)


def _argv(demo, out_dir, *extra):
    in_dir, cfg_path, geo, normal, _, _ = demo
    return ["-cfg", cfg_path, "-in_dir", in_dir, "-out_dir", str(out_dir),
            "-ckpt", geo, "-normal_ckpt", normal, "-mcube_res", str(RES),
            "-img_size", str(SIZE), "-allow_random_hps", *extra]


def test_cli_writes_the_artifact_set(demo, tmp_path, capsys):
    from icon_tpu_torch.apps.infer import main
    out = tmp_path / "out"
    records = main(_argv(demo, out, "-loop_smpl", "2", "-loop_cloth", "1"),
                   device="cpu")
    log = capsys.readouterr().out
    assert "recon:" in log and "loaded" in log
    assert [r["name"] for r in records] == ["matte", "scene"]
    for name in ("matte", "scene"):
        for suffix in ARTIFACTS:
            assert osp.exists(out / f"{name}{suffix}"), f"{name}{suffix}"
        fit = np.load(out / f"{name}_smpl.npy", allow_pickle=True).item()
        assert {"betas", "pose", "orient", "trans", "scale"} <= set(fit)
        assert fit["pose"].shape == (1, 23, 3, 3)
        with Image.open(out / f"{name}_smpl.gif") as gif:
            assert gif.n_frames == 2 and gif.size == (3 * SIZE, SIZE)
        with Image.open(out / f"{name}_overlap.png") as png:
            assert png.size == (2 * SIZE, SIZE)
    from icon_tpu_torch.utils.io import load_obj
    for r in records:
        assert len(r["fit_losses"]) == 2 and len(r["cloth_losses"]) == 1
        assert np.isfinite(r["fit_losses"] + r["cloth_losses"]).all()
        v, f = load_obj(out / f"{r['name']}_recon.obj")
        assert (len(v), len(f)) == r["recon"] and len(f) > 500
        assert np.abs(v).max() <= 1.0 + 1e-6
        v, f = load_obj(out / f"{r['name']}_recon_color.obj")
        assert (len(v), len(f)) == r["final"] and np.isfinite(v).all()
        assert set(r["stages"]) >= {"preprocess", "hps", "fit", "recon",
                                    "remesh", "cloth", "color", "writes"}


def test_loop_smpl_0_with_a_fit_override(demo, tmp_path):
    """``-loop_smpl 0``: the override's body, written as it is (y flipped),
    its parameters in ``_smpl.npy``, no gif; ``-no_remesh`` and no cloth
    loop: the coloured mesh is the recon."""
    import shutil
    from icon_tpu_torch.apps.infer import main
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24
    from icon_tpu_torch.models.smplx.lbs import batch_rodrigues
    from icon_tpu_torch.utils.io import load_obj
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    shutil.copy(osp.join(demo[0], "matte.png"), in_dir / "matte.png")
    rng = np.random.RandomState(4)
    fit = {"betas": rng.randn(10).astype(np.float32) * 0.3,
           "body_pose": rng.randn(69).astype(np.float32) * 0.1,
           "global_orient": np.array([np.pi, 0, 0], np.float32),
           "transl": np.array([0.02, -0.1, 0.0], np.float32),
           "scale": np.float32(0.9)}
    np.savez(in_dir / "matte_smpl.npz", **fit)
    out = tmp_path / "out"
    argv = _argv(demo, out, "-loop_smpl", "0", "-loop_cloth", "0",
                 "-no_remesh")
    argv[argv.index("-in_dir") + 1] = str(in_dir)
    (record,) = main(argv, device="cpu")
    assert record["fit_losses"] == [] and record["cloth_losses"] == []
    assert record["final"] == record["recon"]
    for suffix in ("_smpl.obj", "_smpl.npy", "_overlap.png", "_recon.obj",
                   "_recon_color.obj"):
        assert osp.exists(out / f"matte{suffix}"), suffix
    for suffix in ("_smpl.gif", "_refine.obj"):
        assert not osp.exists(out / f"matte{suffix}"), suffix

    body = _synthetic_smpl24()
    rot = batch_rodrigues(torch.from_numpy(np.concatenate(
        [fit["global_orient"], fit["body_pose"]]).reshape(-1, 3)))
    with torch.no_grad():
        v, _ = body(betas=torch.from_numpy(fit["betas"][None]),
                    global_orient=rot[:1].reshape(1, 9),
                    body_pose=rot[1:].reshape(1, -1), pose2rot=False)
    want = (v[0].numpy() + fit["transl"]) * fit["scale"] * [1, -1, 1]
    got, faces = load_obj(out / "matte_smpl.obj")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(faces, body.faces)
    saved = np.load(out / "matte_smpl.npy", allow_pickle=True).item()
    np.testing.assert_allclose(saved["betas"], fit["betas"][None])
    assert saved["scale"] == pytest.approx(0.9)


def test_checkpoint_rules_match_the_jax_port(demo, tmp_path):
    """The port's load of the two files equals the JAX package's
    ``port_icon_checkpoint`` of them (carried back by
    ``state_dict_from_flax``), tensor for tensor; the files' other entries
    are dropped, and a file missing a tensor of its scope raises."""
    from icon_tpu.training.checkpoints import partial_warm_start
    from icon_tpu.utils.torch_port import (load_torch_state,
                                           port_icon_checkpoint)
    from icon_tpu_torch.apps.infer import checkpoint_state
    from icon_tpu_torch.recon.frame import seeded_state
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    from torch_port_helpers import init_jax_icon
    _, _, geo, normal, cfg, state = demo
    base = seeded_state(cfg, 9, normal_net=True)
    got = checkpoint_state(base, geo, normal)
    assert set(got) == set(base)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), k)

    _, variables = init_jax_icon(normalnet_cfg(), normal_net=True)
    params, stats, _ = port_icon_checkpoint(
        variables["params"], icon_state=load_torch_state(geo),
        normal_state=load_torch_state(normal))
    want = state_dict_from_flax(params, partial_warm_start(
        variables["batch_stats"], stats))
    assert set(want) == set(got)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v, k)

    partial = {k: v for k, v in state.items()
               if k.startswith("if_regressor.")}
    bad = str(tmp_path / "bad.ckpt")
    torch.save({"state_dict": {"netG." + k: v for k, v in partial.items()}},
               bad)
    with pytest.raises(KeyError, match="lack"):
        checkpoint_state(base, bad)
    torch.save({"state_dict": {"netG.netX.w": torch.zeros(1)}}, bad)
    with pytest.raises(KeyError, match="no place"):
        checkpoint_state(base, normal=bad)


@pytest.mark.parametrize("extra, item", [
    (["-num_devices", "2"], "A10"),
    (["-export_video"], "A7 \\(rest\\)"),
    (["-seg_dir", "segs"], "A7 \\(rest\\)"),
    (["-ckpt", "DIR"], "A10"),
    (["-hps_type", "pixie"], "A8 \\(rest\\)"),
])
def test_unported_options_raise(demo, tmp_path, monkeypatch, extra, item):
    """Each option the port lacks raises, naming its ROADMAP item. The A7
    (rest) and A8 (rest) options are ported: they run on one photo and
    write their artifacts."""
    from icon_tpu_torch.apps.infer import main
    in_dir, cfg_path = demo[0], demo[1]
    if item.startswith("A7"):
        _video_and_garments(demo, tmp_path, monkeypatch, extra[0])
        return
    if item.startswith("A8"):
        _pixie_run(demo, tmp_path, monkeypatch)
        return
    extra = [str(tmp_path) if a == "DIR" else a for a in extra]
    with pytest.raises(NotImplementedError, match=item):
        main(["-cfg", cfg_path, "-in_dir", in_dir, "-out_dir",
              str(tmp_path / "out"), "-allow_random_hps", *extra],
             device="cpu")


@pytest.mark.parametrize("prior", ["pifu", "pamir"])
def test_prior_cli_runs(tmp_path, monkeypatch, prior):
    """The CLI with a pifu or a pamir config (image + normals; pifu's
    without the filter, whose seeded readout extrudes the photo's
    silhouette) on the scene photo, two fit and one cloth iteration, no
    remesh,
    with its seeded reference-layout checkpoint (``prior_readout``; pamir's
    with the volume encoder's modules the reference never runs, which the
    loader drops): pifu fits nothing and writes no ``_smpl.*`` artifact but
    the overlap; pamir fits and voxelizes the fitted body's surface (no
    tetra assets installed) once; both reconstruct a bounded mesh."""
    import dataclasses
    import os
    from icon_tpu_torch.apps.infer import main
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.utils.synthetic import write_demo_inputs
    cfg = port_cfg(normalnet_cfg())
    cfg = cfg.replace(net=dataclasses.replace(
        cfg.net, prior_type=prior, voxel_res=64, use_filter=prior == "pamir",
        in_geo=(("image", 3), ("normal_F", 3), ("normal_B", 3))))
    paths = write_demo_inputs(str(tmp_path / "inputs"), cfg, photo_size=96,
                              subdiv=2, seed=3)
    os.remove(osp.join(paths["in_dir"], "matte.png"))
    monkeypatch.setenv("ICON_TPU_DATA_DIR", paths["data_dir"])
    geo = torch.load(paths["ckpt"], weights_only=False)["state_dict"]
    assert ("netG.ve.conv_out1.weight" in geo) == (prior == "pamir")
    assert ("netG.ve.res1.conv3.weight" in geo) == (prior == "pamir")
    calls = []
    volume_features = HGPIFuNet.volume_features
    monkeypatch.setattr(HGPIFuNet, "volume_features", lambda self, *a: (
        calls.append(a[0].shape), volume_features(self, *a))[1])
    argv = ["-cfg", paths["cfg"], "-in_dir", paths["in_dir"], "-out_dir",
            paths["out_dir"], "-ckpt", paths["ckpt"], "-normal_ckpt",
            paths["normal_ckpt"], "-mcube_res", str(RES), "-img_size",
            str(SIZE), "-allow_random_hps", "-loop_smpl", "2",
            "-loop_cloth", "1", "-no_remesh"]
    (record,) = main(argv, device="cpu")
    written = sorted(os.listdir(paths["out_dir"]))
    fitted = prior == "pamir"
    want = [s for s in ARTIFACTS if fitted or not s.startswith("_smpl")]
    assert written == sorted(f"scene{s}" for s in want)
    assert len(record["fit_losses"]) == (2 if fitted else 0)
    assert calls == ([(1, 8000, 3)] if fitted else [])
    assert np.isfinite(record["fit_losses"] + record["cloth_losses"]).all()
    assert len(record["cloth_losses"]) == 1 and record["recon"][1] > 100
    from icon_tpu_torch.utils.io import load_obj
    v, _ = load_obj(osp.join(paths["out_dir"], "scene_recon.obj"))
    assert np.abs(v).max() <= 1.0 + 1e-6


def test_export_video_needs_cv2(demo, tmp_path, monkeypatch):
    """Without OpenCV, ``-export_video`` raises ImportError naming cv2
    before any work: no output directory is made."""
    import sys
    from icon_tpu_torch.apps.infer import main
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        main(_argv(demo, tmp_path / "out", "-export_video"), device="cpu")
    assert not osp.exists(tmp_path / "out")


def _video_and_garments(demo, tmp_path, monkeypatch, flag):
    """The CLI with ``flag`` on the scene photo (one fit and one cloth
    iteration, no remesh): ``-export_video`` writes ``scene_cloth.mp4``
    (4 frames of the photo, its normals and the two meshes at 256^2, read
    back with cv2) and captures the fit gif; ``-seg_dir`` writes each
    garment of ``scene.json`` whose polygons select faces, its OBJ the
    size the record gives."""
    import functools
    import json
    import shutil
    import cv2
    import icon_tpu_torch.apps.infer as infer
    from icon_tpu_torch.utils.io import load_obj
    from icon_tpu_torch.utils.synthetic import garment_polygons
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    shutil.copy(osp.join(demo[0], "scene.png"), in_dir / "scene.png")
    monkeypatch.setattr(infer, "export_turntable_video", functools.partial(
        infer.export_turntable_video, n_frames=4))
    segs = tmp_path / "segs"
    segs.mkdir()
    with open(segs / "scene.json", "w") as f:
        json.dump(garment_polygons(_synthetic_smpl24(subdiv=2)) +
                  [{"type": "far", "coordinates": [[0, 0, 4, 0, 4, 4]]}], f)
    out = tmp_path / "out"
    extra = ["-export_video"] if flag == "-export_video" else \
        ["-seg_dir", str(segs)]
    argv = _argv(demo, out, "-loop_smpl", "1", "-loop_cloth", "1",
                 "-no_remesh", *extra)
    argv[argv.index("-in_dir") + 1] = str(in_dir)
    (record,) = infer.main(argv, device="cpu")
    if flag == "-export_video":
        cap = cv2.VideoCapture(str(out / "scene_cloth.mp4"))
        shapes = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            shapes.append(frame.shape)
        cap.release()
        assert shapes == [(256, 4 * 256, 3)] * 4
        assert osp.exists(out / "scene_smpl.gif")      # capture_every 1
        assert record["stages"]["video"] > 0 and record["garments"] == {}
        assert not osp.exists(out / "scene_upper.obj")
    else:
        assert sorted(record["garments"]) == ["lower", "upper"]
        for kind, (nv, nf) in record["garments"].items():
            v, f = load_obj(out / f"scene_{kind}.obj")
            assert (len(v), len(f)) == (nv, nf) and nf > 20
            assert nf < record["final"][1]
        assert not osp.exists(out / "scene_far.obj")
        assert not osp.exists(out / "scene_cloth.mp4")


def _pixie_run(demo, tmp_path, monkeypatch):
    """``-hps_type pixie`` on the scene photo (two fit iterations and one
    cloth iteration, no remesh) with a seeded ``pixie_model.tar`` at the
    published widths under ``ICON_TPU_DATA_DIR/HPS/pixie_data`` and an
    SMPL-X cmap asset of the body's length: the loader reads the file, the
    fit frame takes the cmap asset, and the artifacts are those of the
    synthetic SMPL-X body (21 body joints, its 10 betas of PIXIE's 200,
    its vertices and faces)."""
    import shutil
    import icon_tpu_torch.recon.frame as frame
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.utils.io import load_obj
    from icon_tpu_torch.utils.synthetic import (pixie_file_layout,
                                                seeded_pixie_state)
    pixie = tmp_path / "HPS" / "pixie_data"
    pixie.mkdir(parents=True)
    torch.save(pixie_file_layout(seeded_pixie_state(4)),
               pixie / "pixie_model.tar")
    body = synthetic_smplx_model(subdiv=4)
    n = body.v_template.shape[0]
    _write_cmap_assets(tmp_path, n, 300, np.random.RandomState(9))
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    cmaps = []
    asset_cmap = frame.asset_cmap
    monkeypatch.setattr(frame, "asset_cmap", lambda k: cmaps.append(
        (k, asset_cmap(k))) or cmaps[-1][1])
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    shutil.copy(osp.join(demo[0], "scene.png"), in_dir / "scene.png")
    out = tmp_path / "out"
    argv = _argv(demo, out, "-loop_smpl", "2", "-loop_cloth", "1",
                 "-no_remesh", "-hps_type", "pixie")
    argv[argv.index("-in_dir") + 1] = str(in_dir)
    argv.remove("-allow_random_hps")
    from icon_tpu_torch.apps.infer import main
    (record,) = main(argv, device="cpu")
    for suffix in ARTIFACTS:
        assert osp.exists(out / f"scene{suffix}"), suffix
    fit = np.load(out / "scene_smpl.npy", allow_pickle=True).item()
    assert fit["pose"].shape == (1, 21, 3, 3)
    assert fit["betas"].shape == (1, 10)
    v, f = load_obj(out / "scene_smpl.obj")
    assert (len(v), len(f)) == (n, len(body.faces))
    assert [k for k, _ in cmaps] == [n] and cmaps[0][1] is not None
    assert np.isfinite(record["fit_losses"] + record["cloth_losses"]).all()
    assert record["recon"][1] > 100


def _write_cmap_assets(root, n_cmap: int, n_smpl: int, rng):
    sd = root / "smpl_related" / "smpl_data"
    sd.mkdir(parents=True)
    np.save(sd / "smplx_cmap.npy", rng.rand(n_cmap, 3))
    np.save(sd / "smplx_verts.npy", rng.randn(n_cmap, 3))
    np.save(sd / "smpl_verts.npy", rng.randn(n_smpl, 3))
    return sd


@pytest.mark.parametrize("assets", ["smplx", "smpl", "absent"])
def test_icon_feats_cmap_branch(tmp_path, monkeypatch, assets):
    """The recon's cmap (``recon/frame.py:asset_cmap`` into ``icon_feats``)
    against the JAX demo's ``_icon_feats`` on one body, with the SMPL-X
    cmap assets the test writes into ``ICON_TPU_DATA_DIR``: the asset
    itself for a body of its vertex count (SMPL-X), the nearest-vertex
    remap for a body of the SMPL vertex count, the bbox-normalized fallback
    without the assets; the same arrays, and the visibility equal. Without
    a cmap given (the serving frames), ``icon_feats`` keeps the bbox cmap
    whatever is installed, as bench.py's batch does."""
    import jax.numpy as jnp
    from icon_tpu.apps.infer import _icon_feats
    from icon_tpu_torch.recon.frame import asset_cmap, body_bins, icon_feats
    from icon_tpu_torch.utils.synthetic import synthetic_body
    v, f = synthetic_body(subdiv=2)
    v = v * 0.9
    if assets != "absent":
        sd = _write_cmap_assets(tmp_path, len(v) if assets == "smplx"
                                else 300, len(v), np.random.RandomState(7))
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    calib = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    want = _icon_feats(jnp.asarray(v), f, calib)
    v_cal = (v * [1, -1, -1]).astype(np.float32)
    bins = body_bins(v_cal, f, 65, "cpu")
    cmap = asset_cmap(len(v))
    assert (cmap is None) == (assets == "absent")
    args = (torch.from_numpy(v), torch.from_numpy(f.astype(np.int64)),
            torch.from_numpy(calib), bins)
    got = icon_feats(*args, None if cmap is None
                     else torch.from_numpy(cmap).float())
    np.testing.assert_array_equal(got["smpl_cmap"].numpy(),
                                  np.asarray(want["smpl_cmap"]))
    np.testing.assert_array_equal(got["smpl_vis"].numpy(),
                                  np.asarray(want["smpl_vis"]))
    if assets == "smplx":
        np.testing.assert_array_equal(got["smpl_cmap"][0].numpy(), np.load(
            sd / "smplx_cmap.npy").astype(np.float32))
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path / "none"))
    bbox = np.asarray(_icon_feats(jnp.asarray(v), f, calib)["smpl_cmap"])
    np.testing.assert_array_equal(icon_feats(*args)["smpl_cmap"].numpy(),
                                  bbox)


@pytest.mark.parametrize("installed", [True, False])
def test_fit_frame_takes_the_cmap_asset(tmp_path, monkeypatch, installed):
    """The fit frame's prep (what the CLI runs) reads the cmap asset for
    its body model when installed, and the bbox cmap otherwise."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import build_fit_frame, seeded_state
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    body = synthetic_smplx_model(subdiv=2)
    n = body.v_template.shape[0]
    if installed:
        sd = _write_cmap_assets(tmp_path, n, 300, np.random.RandomState(8))
    monkeypatch.setenv("ICON_TPU_DATA_DIR", str(tmp_path))
    cfg = port_cfg(normalnet_cfg())
    fr = build_fit_frame(cfg, seeded_state(cfg, 0, normal_net=True), body,
                         32, "cpu", loop_smpl=0)
    item = synthetic_fit_item(fr.body, 32)
    image, calib = torch.from_numpy(item["image"]), \
        torch.from_numpy(item["calib"])
    smpl, _ = fr.prep(image, fr.fit(item), calib)
    cmap = smpl["smpl_cmap"][0].numpy()
    if installed:
        np.testing.assert_array_equal(cmap, np.load(
            sd / "smplx_cmap.npy").astype(np.float32))
    else:
        v = smpl["smpl_verts"][0].numpy()
        lo, hi = v.min(0), v.max(0)
        np.testing.assert_allclose(cmap, (v - lo) / (hi - lo), rtol=0,
                                   atol=1e-6)
