"""The port runs without JAX and without the JAX package: importing
icon_tpu_torch and running one tiny CPU frame of each kind (normals given;
normals predicted by the NormalNet from the body's renders; the demo's fit
frame: body fit, recon, remesh, cloth refinement, colours; and with the
pifu and pamir priors) and the demo CLI
on photos (YAML config, seeded checkpoint, PyMAF, fit, recon, cloth,
colours; then the RGB photo with the YOLO detector, U^2-Net matting and
PARE installed, the turntable video and the garments) and PIXIE and HybrIK
at narrow widths, the geometry trainer (the fixture, a train step
with loader workers, the evaluation), the dataset renderer (one subject
with PRT), the NormalNet trainer (one step) and the Poisson
reconstruction leaves ``jax``, ``flax`` and ``icon_tpu`` out of
``sys.modules``, and no file of the package (the photo path's, the other
estimators', the trainers' and the renderer's modules among them) nor
``chip_smoke.py`` imports them."""

import os
import os.path as osp
import re
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))

_FRAME = r"""
import dataclasses
import os
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from icon_tpu_torch.config import Config, NetConfig
from icon_tpu_torch.models.hgpifu import HGPIFuNet
from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
from icon_tpu_torch.recon.frame import build_frame, build_normalnet_frame
cfg = Config(test_mode=False, net=NetConfig(
    mlp_dim=(256, 16, 16, 16, 8, 1), res_layers=(2, 3, 4), num_stack=1,
    prior_type="icon", use_filter=True,
    in_geo=(("normal_F", 3), ("normal_B", 3)),
    smpl_feats=("sdf", "norm", "vis", "cmap"), norm_mlp="batch",
    hourglass_dim=6, smpl_dim=7))
torch.manual_seed(0)
state = HGPIFuNet(cfg, normal_net=False).state_dict()
batch = synthetic_icon_batch(np.random.RandomState(0), B=1, image_size=32,
                             n_samples=8, subdiv=2)
stats, mesh, verts, faces = build_frame(cfg, state, batch, 64, "cpu").frame()
assert len(faces) > 1000 and np.isfinite(verts).all()
cfg = cfg.replace(net=dataclasses.replace(
    cfg.net, in_nml=(("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)), ngf=4,
    n_downsampling=2, n_blocks=1))
state = HGPIFuNet(cfg).state_dict()
fr = build_normalnet_frame(cfg, state, batch, 64, "cpu")
stats, mesh, verts, faces = fr.frame()
assert len(faces) > 1000 and np.isfinite(verts).all()
from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
from icon_tpu_torch.recon.frame import build_fit_frame, variant_occ
from icon_tpu_torch.utils.synthetic import synthetic_fit_item
body = synthetic_smplx_model(subdiv=2)
out = build_fit_frame(cfg, state, body, 64, "cpu", loop_smpl=1, loop_cloth=1,
                      field=variant_occ).frame(synthetic_fit_item(body, 32))
assert len(out.faces) > 1000 and bool(torch.isfinite(out.verts).all())
assert np.isfinite(out.fit.losses + out.cloth_losses).all()
for prior in ("pifu", "pamir"):
    pcfg = cfg.replace(net=dataclasses.replace(
        cfg.net, prior_type=prior, voxel_res=32,
        in_geo=(("image", 3), ("normal_F", 3), ("normal_B", 3))))
    out = build_fit_frame(pcfg, HGPIFuNet(pcfg).state_dict(), body, 64, "cpu",
                          loop_smpl=1, loop_cloth=1, field=variant_occ).frame(
        synthetic_fit_item(body, 32))
    assert len(out.faces) > 1000 and len(out.fit.losses) == (prior == "pamir")
import tempfile
from icon_tpu_torch.apps.infer import main
from icon_tpu_torch.utils.synthetic import write_demo_inputs
with tempfile.TemporaryDirectory() as d:
    p = write_demo_inputs(d, cfg, photo_size=64, subdiv=2)
    recs = main(["-cfg", p["cfg"], "-in_dir", p["in_dir"], "-out_dir",
                 p["out_dir"], "-ckpt", p["ckpt"], "-normal_ckpt",
                 p["normal_ckpt"], "-loop_smpl", "1", "-loop_cloth", "1",
                 "-mcube_res", "64", "-img_size", "32", "-no_remesh",
                 "-allow_random_hps"], device="cpu")
    assert all(r["final"][1] > 100 and len(r["cloth_losses"]) == 1
               for r in recs) and len(recs) == 2
    assert os.path.exists(os.path.join(p["out_dir"],
                                       "scene_recon_color.obj"))
    import functools
    import icon_tpu_torch.apps.infer as infer
    p = write_demo_inputs(os.path.join(d, "w"), cfg, photo_size=64, subdiv=2,
                          detector=True, segmenter="lite", pare_ckpt=True,
                          seg_dir=True)
    os.remove(os.path.join(p["in_dir"], "matte.png"))
    os.environ["ICON_TPU_DATA_DIR"] = p["data_dir"]
    infer.export_turntable_video = functools.partial(
        infer.export_turntable_video, n_frames=2)
    (rec,) = main(["-cfg", p["cfg"], "-in_dir", p["in_dir"], "-out_dir",
                   p["out_dir"], "-ckpt", p["ckpt"], "-normal_ckpt",
                   p["normal_ckpt"], "-loop_smpl", "1", "-loop_cloth", "1",
                   "-mcube_res", "64", "-img_size", "32", "-no_remesh",
                   "-hps_type", "pare", "-export_video", "-seg_dir",
                   p["seg_dir"]], device="cpu")
    assert {"detect", "matte", "video", "garments"} <= set(rec["stages"])
    assert os.path.exists(os.path.join(p["out_dir"], "scene_cloth.mp4"))
from icon_tpu_torch.models.hybrik.net import build_hybrik
from icon_tpu_torch.models.pixie.net import PixieConfig, build_pixie
est, _ = build_pixie(PixieConfig(n_shape=12, n_exp=6, n_tex=4, n_light=5,
    feat_dim=256, hr_width=8, hr_stem=16, resnet_width=8,
    resnet_layers=(1, 1, 1, 1), reg_channels=(32,), share_channels=(32, 32),
    mod_channels=(32,)))
hybrik, _ = build_hybrik(backbone_width=8, backbone_layers=(1, 1, 1, 1))
with torch.no_grad():
    out = est(torch.rand(1, 64, 64, 3))
    assert bool(torch.isfinite(out["vertices"]).all())
    out = hybrik(torch.rand(1, 3, 64, 64))
    assert bool(torch.isfinite(out["pred_vertices"]).all())
from icon_tpu_torch.config import save_config
from icon_tpu_torch.data.fixture import fixture_config, make_synthetic_dataset
import icon_tpu_torch.apps.train as train
with tempfile.TemporaryDirectory() as d:
    make_synthetic_dataset(d, n_subjects=2, n_views=2, size=32, vis_res=64,
                           device="cpu")
    tcfg = fixture_config(d, n_views=2, num_sample_geo=64, image_size=32)
    save_config(tcfg.replace(ckpt_dir=d, num_threads=2, mcube_res=32),
                os.path.join(d, "t.yaml"))
    rec = train.main(["-cfg", os.path.join(d, "t.yaml"), "--max_steps", "1"],
                     device="cpu")
    assert rec["steps"] == 1 and np.isfinite(rec["losses"]).all()
    rec = train.main(["-cfg", os.path.join(d, "t.yaml"), "-test",
                      "--max_eval_items", "1"], device="cpu")
    assert len(rec["items"]) == 1
from icon_tpu_torch.apps import render as render_app
from icon_tpu_torch.apps import train_normal
from icon_tpu_torch.ops.poisson import poisson_reconstruct
from icon_tpu_torch.utils.synthetic import icosphere
with tempfile.TemporaryDirectory() as d:
    make_synthetic_dataset(d, n_subjects=1, n_views=2, size=32, vis_res=64,
                           device="cpu")
    recs = render_app.main(["-root", d, "-dataset", "synth", "-views", "2",
                            "-size", "32", "-prt", "-prt_dirs", "2",
                            "-vis_res", "64", "-procs", "1"], device="cpu")
    assert [(r["status"], r["body"]) for r in recs] == [("rendered", True)]
    ncfg = fixture_config(d, n_views=2, image_size=32)
    save_config(ncfg.replace(ckpt_dir=d, num_threads=0, batch_size=1),
                os.path.join(d, "n.yaml"))
    rec = train_normal.main(["-cfg", os.path.join(d, "n.yaml"),
                             "--max_steps", "1"], device="cpu")
    assert rec["steps"] == 1 and np.isfinite(rec["losses"]).all()
v, f = icosphere(2)
pv, pf = poisson_reconstruct(v * 0.6, f, res=16, device="cpu")
assert len(pf) > 100
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "flax")))
print("JAX_MODULES", bad)
ref = sorted(m for m in sys.modules if m == "icon_tpu" or m.startswith("icon_tpu."))
print("ICON_TPU_MODULES", ref)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _FRAME], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES []" in proc.stdout, proc.stdout[-2000:]
    assert "ICON_TPU_MODULES []" in proc.stdout, proc.stdout[-2000:]


# the photo path's modules, the other estimators', the priors', the
# trainers' and the renderer's, which the scans below must reach
PHOTO_PATH = ("models/yolo.py", "models/u2net.py", "models/detector.py",
              "models/pare/hrnet.py", "models/pare/net.py",
              "models/pare/convert.py", "ops/cloth_extraction.py",
              "data/test_dataset.py", "apps/infer.py", "render/render.py",
              "models/pixie/hrnet.py", "models/pixie/net.py",
              "models/pixie/convert.py", "models/hybrik/ik.py",
              "models/hybrik/net.py", "models/hybrik/convert.py",
              # the priors' modules
              "models/volume_encoder.py", "models/smplx/tetra.py",
              "ops/voxelize.py", "kernels/voxelize.py", "csrc/voxelize.cu",
              "ops/grid_sample.py", "ops/projection.py", "models/hgpifu.py",
              # the geometry trainer's
              "apps/train.py", "data/datasets.py", "data/fixture.py",
              "data/render_dataset.py", "training/train_step.py",
              "training/checkpoints.py", "training/logging.py",
              "training/visuals.py", "eval/evaluator.py", "eval/test_loop.py",
              "ops/sdf.py", "ops/winding_np.py", "utils/convert.py",
              # the dataset renderer's, the NormalNet trainer's and the
              # surface tools'
              "apps/render.py", "apps/train_normal.py",
              "apps/tetrahedronize.py", "models/vgg.py",
              "training/normal_step.py", "ops/poisson.py", "ops/raster.py")


def test_no_jax_import_in_package_sources():
    pkg = osp.join(ROOT, "icon_tpu_torch")
    pat = re.compile(r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b)", re.M)
    checked = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(osp.join(dirpath, name)) as f:
                    assert not pat.search(f.read()), name
                checked.append(osp.relpath(osp.join(dirpath, name), pkg))
    assert len(checked) >= 20
    assert set(PHOTO_PATH) <= set(checked)


def _port_sources():
    pkg = osp.join(ROOT, "icon_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cc")):
                yield osp.join(dirpath, name)
    yield osp.join(ROOT, "chip_smoke.py")


def test_no_icon_tpu_import_in_port_sources():
    """Neither the package nor chip_smoke.py imports the JAX package, not
    even its modules that do not import JAX: the port keeps its own copies
    (config, clean_mesh, the synthetic body, the lattice decoder)."""
    pat = re.compile(r"^\s*(from|import)\s+icon_tpu(\.|\s|$)", re.M)
    checked = []
    for path in _port_sources():
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"
        checked.append(osp.relpath(path, osp.join(ROOT, "icon_tpu_torch")))
    assert len(checked) >= 40
    assert set(PHOTO_PATH) <= set(checked)
