"""Shared setup for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs; parameters come from flax ``init``
(norm scales and biases and BatchNorm running stats randomized so that eval
mode exercises every ported tensor) and reach the port through
``state_dict_from_flax``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import icon_tpu.config
import icon_tpu_torch.config
from icon_tpu.config import Config

torch.set_num_threads(1)


def _config_as(cfg, module):
    """``cfg`` rebuilt field for field from ``module``'s dataclasses."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["net"] = module.NetConfig(**dataclasses.asdict(cfg.net))
    kw["dataset"] = module.DatasetConfig(**dataclasses.asdict(cfg.dataset))
    return module.Config(**kw)


def port_cfg(cfg: Config) -> icon_tpu_torch.config.Config:
    """The port's config with the fields of the JAX package's ``cfg``."""
    return _config_as(cfg, icon_tpu_torch.config)


def icon_cfg(mlp_dim=(256, 32, 64, 32, 16, 1)) -> Config:
    """bench.py's icon-filter config (2 stacks, hourglass_dim 6, batch-norm
    MLP, 7 SMPL features) at a narrow MLP width (13-32-64-32-16-1), as the
    JAX package's ``Config`` (:func:`port_cfg` gives the port's)."""
    from icon_tpu_torch.recon.frame import bench_config
    cfg = _config_as(bench_config(), icon_tpu.config)
    return cfg.replace(net=dataclasses.replace(cfg.net, mlp_dim=mlp_dim))


def _randomize(tree, rng):
    """Perturb norm scales/biases and conv biases off their init values."""
    def walk(node, path=()):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node)
        leaf = path[-1]
        if leaf == "scale":
            arr = arr + 0.2 * rng.randn(*arr.shape).astype(arr.dtype)
        elif leaf == "bias":
            arr = arr + 0.1 * rng.randn(*arr.shape).astype(arr.dtype)
        elif leaf == "mean":
            arr = 0.1 * rng.randn(*arr.shape).astype(arr.dtype)
        elif leaf == "var":
            arr = rng.uniform(0.5, 1.5, arr.shape).astype(arr.dtype)
        return arr
    return walk(tree)


def normalnet_cfg(ngf=8, n_downsampling=2, n_blocks=2, **net) -> Config:
    """:func:`icon_cfg` with a NormalNet of the given widths (narrow by
    default; the published ones are 64, 4, 9)."""
    cfg = icon_cfg(**net)
    return cfg.replace(net=dataclasses.replace(
        cfg.net, ngf=ngf, n_downsampling=n_downsampling, n_blocks=n_blocks))


def init_jax_icon(cfg: Config, seed: int = 0, normal_net: bool = False):
    """(flax HGPIFuNet, variables as numpy trees) with randomized norms and
    biases. With ``normal_net`` the init batch holds the NormalNet's inputs
    (image, T_normal_F/B) instead of the normal maps, so the params carry
    the ``normal_filter`` scope."""
    from icon_tpu.models.hgpifu import HGPIFuNet
    net = HGPIFuNet(cfg)
    small = jnp.zeros((1, 64, 64, 3))
    maps = ("image", "T_normal_F", "T_normal_B") if normal_net \
        else ("normal_F", "normal_B")
    batch = {**{k: small for k in maps},
             "sample": jnp.zeros((1, 8, 3)), "calib": jnp.eye(4)[None],
             "smpl_verts": jnp.zeros((1, 32, 3)),
             "smpl_faces": jnp.zeros((16, 3), jnp.int32),
             "smpl_cmap": jnp.zeros((1, 32, 3)),
             "smpl_vis": jnp.zeros((1, 32, 1))}
    variables = jax.jit(lambda k, b: net.init(k, b, train=False))(
        jax.random.PRNGKey(seed), batch)
    rng = np.random.RandomState(seed + 100)
    return net, {k: _randomize(v, rng) for k, v in variables.items()}


def port_state(variables) -> dict:
    """The port's torch state dict for flax ``variables``."""
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    sd = state_dict_from_flax(variables["params"],
                              variables.get("batch_stats"))
    return {k: t(v) for k, v in sd.items()}


def body(subdiv: int = 3):
    """The synthetic body with the batch's cmap/vis and its face table."""
    from icon_tpu.ops.sdf_fast import build_vertex_face_table
    from icon_tpu.utils.synthetic import synthetic_body
    v, f = synthetic_body(subdiv=subdiv)
    cmaps = ((v - v.min(0)) / (v.max(0) - v.min(0))).astype(np.float32)
    vis = (v[:, 2:3] > 0).astype(np.float32)
    table = build_vertex_face_table(f, len(v))
    return v, f, cmaps, vis, table


def lattice_columns(v, f, res1: int):
    """Compact column bins of ``v, f`` on the engine's (res1)^2 lattice, as
    bench.py builds them: (cb, cm, tids, col_x, col_y, cross_meta)."""
    from icon_tpu.ops.sdf_fast import build_column_bins
    col_x = np.linspace(-1.0, 1.0, res1, dtype=np.float32)
    col_y = np.linspace(1.0, -1.0, res1, dtype=np.float32)
    cb, cm, tids = build_column_bins(v, f, col_x, col_y, compact=True)
    meta = np.array([-1.0, 1.0, (res1 - 1) / 2.0, (res1 - 1) / -2.0,
                     float(res1), float(res1)], np.float32)
    return cb, cm, tids, col_x, col_y, meta


def pymaf_pair(width: int = 16, layers=(1, 1, 1, 1), subdiv: int = 3,
               seed: int = 0):
    """The JAX PyMAF and the port's at a small width on the 24-joint
    synthetic SMPL: (JAX net, its variables as numpy with BatchNorm stats,
    scales and biases randomized, the port's net with those weights through
    ``pymaf_state_from_flax``, (JAX body, port body, dmap))."""
    from icon_tpu.models.pymaf.net import PyMAF as JPyMAF
    from icon_tpu.models.pymaf.net import _synthetic_smpl24
    from icon_tpu_torch.models.pymaf.net import PyMAF as PPyMAF
    from icon_tpu_torch.utils.convert import (body_model_from_jax,
                                              pymaf_state_from_flax)
    jbody = _synthetic_smpl24(subdiv=subdiv)
    pbody = body_model_from_jax(jbody)
    V = len(np.asarray(jbody.v_template))
    dmap = np.zeros((431, V), np.float32)
    dmap[np.arange(431), np.linspace(0, V - 1, 431).astype(np.int32)] = 1.0

    def jfwd(betas, rotmats):
        return jbody.forward(betas=betas,
                             global_orient=rotmats[:, :1].reshape(-1, 9),
                             body_pose=rotmats[:, 1:].reshape(
                                 rotmats.shape[0], -1), pose2rot=False)

    def pfwd(betas, rotmats):
        return pbody(betas=betas, global_orient=rotmats[:, :1].reshape(-1, 9),
                     body_pose=rotmats[:, 1:].reshape(rotmats.shape[0], -1),
                     pose2rot=False)

    jnet = JPyMAF(smpl_forward=jfwd, dmap=dmap, backbone_width=width,
                  backbone_layers=tuple(layers))
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 224, 224, 3)))
    rng = np.random.RandomState(seed + 2)
    variables = {k: _randomize(v, rng) for k, v in variables.items()}
    pnet = PPyMAF(pfwd, dmap, backbone_width=width,
                  backbone_layers=tuple(layers))
    pnet.load_state_dict({k: t(v) for k, v in
                          pymaf_state_from_flax(variables).items()})
    return jnet, variables, pnet.eval(), (jbody, pbody, dmap)


def t(x, dtype=None):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)
