"""The port runs without JAX: importing icon_tpu_torch and running one tiny
CPU frame of each kind (normals given; normals predicted by the NormalNet
from the body's renders; the demo's fit frame: body fit, recon, remesh,
cloth refinement, colours) leaves ``jax`` out of ``sys.modules``, and no
file of the package imports it."""

import os
import os.path as osp
import re
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))

_FRAME = r"""
import dataclasses
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from icon_tpu.config import Config, NetConfig
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
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "flax")))
print("JAX_MODULES", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _FRAME], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES []" in proc.stdout, proc.stdout[-2000:]


def test_no_jax_import_in_package_sources():
    pkg = osp.join(ROOT, "icon_tpu_torch")
    pat = re.compile(r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b)", re.M)
    checked = 0
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(osp.join(dirpath, name)) as f:
                    assert not pat.search(f.read()), name
                checked += 1
    assert checked >= 20
