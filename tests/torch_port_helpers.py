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


def prior_cfg(prior: str, use_filter: bool = True, hg_down="ave_pool",
              norm="group", voxel_res: int = 32, voxel_dim: int = 8,
              image: bool = True) -> Config:
    """:func:`icon_cfg` with ``prior`` (icon, pifu or pamir) and the image
    filter's options; with ``image`` the in_geo stack is image + normals (9
    channels), otherwise the normals; PaMIR's volume at ``voxel_res`` with
    ``voxel_dim`` features (narrow; the config's defaults are 128 and
    32)."""
    cfg = icon_cfg()
    in_geo = ((("image", 3),) if image else ()) + (("normal_F", 3),
                                                   ("normal_B", 3))
    return cfg.replace(net=dataclasses.replace(
        cfg.net, prior_type=prior, use_filter=use_filter, hg_down=hg_down,
        norm=norm, voxel_res=voxel_res, voxel_dim=voxel_dim,
        in_geo=in_geo))


def init_jax_icon(cfg: Config, seed: int = 0, normal_net: bool = False):
    """(flax HGPIFuNet, variables as numpy trees) with randomized norms and
    biases, for any prior. With ``normal_net`` the init batch holds the
    NormalNet's inputs (image, T_normal_F/B) instead of the normal maps, so
    the params carry the ``normal_filter`` scope."""
    from icon_tpu.models.hgpifu import HGPIFuNet
    net = HGPIFuNet(cfg)
    small = jnp.zeros((1, 64, 64, 3))
    maps = ("image", "T_normal_F", "T_normal_B") if normal_net \
        else ("image", "normal_F", "normal_B")
    voxels = {"voxel_verts": jnp.zeros((1, 64, 3)),
              "voxel_codes": jnp.zeros((64, 3))} \
        if cfg.net.prior_type == "pamir" else {}
    batch = {**{k: small for k in maps}, **voxels,
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


def random_variables(shapes, seed: int):
    """numpy variables for the ``jax.eval_shape`` tree ``shapes``, drawn
    from ``seed`` without running the flax init: kernels N(0, 1/fan_in),
    biases and batch means 0.1 N(0, 1), norm scales and other parameters
    1 + 0.1 N(0, 1), batch variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            v = rng.randn(*a.shape) / np.sqrt(fan_in)
        elif name in ("bias", "mean", "init_shape"):
            v = 0.1 * rng.randn(*a.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, a.shape)
        else:
            v = 1.0 + 0.1 * rng.randn(*a.shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nan_variables(shapes):
    """numpy variables of NaN for the ``jax.eval_shape`` tree ``shapes``."""
    return jax.tree_util.tree_map(
        lambda a: np.full(a.shape, np.nan, np.float32), shapes)


def unwritten_leaves(variables) -> list:
    """The paths of ``variables``' leaves that still hold a NaN."""
    return [jax.tree_util.keystr(p) for p, a in
            jax.tree_util.tree_leaves_with_path(variables)
            if np.isnan(np.asarray(a)).any()]


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (torch or numpy)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# PIXIE at the narrow widths of the parity tests
PIXIE_NARROW = dict(n_shape=12, n_exp=6, n_tex=4, n_light=5, feat_dim=256,
                    hr_width=8, hr_stem=16, resnet_width=8,
                    resnet_layers=(1, 1, 1, 1), reg_channels=(32,),
                    share_channels=(32, 32), mod_channels=(32,))


def pixie_shapes(kw, img: int = 64):
    """The ``jax.eval_shape`` variables of the JAX PIXIE at ``kw``."""
    from icon_tpu.models.pixie.net import PIXIE, PixieConfig
    d = jnp.zeros((1, img, img, 3))
    return jax.eval_shape(lambda: PIXIE(cfg=PixieConfig(**kw)).init(
        jax.random.PRNGKey(0), d, d, d, d, train=False))


def _near_rest(variables, hand_logit):
    """The regressors' last layers at 1e-4 around the rest body
    (``pixie_rest_biases``; the random features reach ~300), so that the 6D
    poses are well conditioned, the camera near the mean and the part crops
    inside the image; the moderators' at 2e-3, the hand's second logit
    raised by ``hand_logit``, so that the hand weights fall on both sides
    of the 0.7 snap."""
    from icon_tpu_torch.models.pixie.net import PixieConfig
    from icon_tpu_torch.utils.synthetic import pixie_rest_biases
    params = variables["params"]
    for name, rest in pixie_rest_biases(PixieConfig(**PIXIE_NARROW)).items():
        mlp = params[f"regressor_{name}"]
        last = mlp[max(mlp, key=lambda k: int(k.split("_")[1]))]
        last["kernel"] = last["kernel"] * 1e-4
        last["bias"] = (np.asarray(rest, np.float32)
                        + 0.01 * last["bias"]).astype(np.float32)
    for part, logit in (("head", 0.0), ("hand", hand_logit)):
        mod = params[f"moderator_{part}_share"]["layers"]
        last = mod[max(mod, key=lambda k: int(k.split("_")[1]))]
        last["kernel"] = last["kernel"] * 2e-3
        last["bias"] = last["bias"] + np.array([0.0, logit], np.float32)
    return variables


def pixie_pair(seed: int = 3, hand_logit: float = 1.35):
    """The JAX PIXIE estimator at :data:`PIXIE_NARROW` with seeded
    variables near the rest body (:func:`random_variables`), those
    variables, and the port's estimator with them through
    ``pixie_state_from_flax``; both on their packages' default SMPL-X body
    (the synthetic one)."""
    from icon_tpu.models.pixie.net import PixieConfig, PixieEstimator
    from icon_tpu_torch.models.pixie import net as P
    from icon_tpu_torch.utils.convert import pixie_state_from_flax
    variables = _near_rest(random_variables(pixie_shapes(PIXIE_NARROW),
                                            seed), hand_logit)
    jest = PixieEstimator(PixieConfig(**PIXIE_NARROW), variables=variables)
    pest = P.PixieEstimator(P.PixieConfig(**PIXIE_NARROW)).eval()
    pest.net.load_state_dict({k: t(v) for k, v in
                              pixie_state_from_flax(variables).items()})
    return jest, variables, pest


# SMPL's kinematic tree: the root and the spine have three children each
SMPL_PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)
HYBRIK_NARROW = dict(depth_dim=8, backbone_layers=(1, 1, 1, 1),
                     backbone_width=8, deconv_filters=(32, 32, 32))


def smpl_tree_bodies(subdiv: int = 2):
    """The 24-joint synthetic SMPL with SMPL's kinematic tree (its own is
    a chain), as (JAX body, port body, rest joints)."""
    import dataclasses
    from icon_tpu.models.pymaf.net import _synthetic_smpl24
    from icon_tpu_torch.utils.convert import body_model_from_jax
    jbody = dataclasses.replace(_synthetic_smpl24(subdiv=subdiv),
                                parents=SMPL_PARENTS)
    rest = np.asarray(jbody.J_regressor @ jbody.v_template, np.float32)
    return jbody, body_model_from_jax(jbody), rest


def rotmat_smpl_forward(body):
    """``(betas, rotmats [B, J, 3, 3]) -> (verts, joints)`` of ``body``,
    either package's."""
    def fwd(betas, r):
        return body.forward(betas=betas, global_orient=r[:, :1].reshape(-1, 9),
                            body_pose=r[:, 1:].reshape(r.shape[0], -1),
                            pose2rot=False)
    return fwd


def hybrik_pair(img: int = 64, seed: int = 5):
    """The JAX HybrIK at :data:`HYBRIK_NARROW` on :func:`smpl_tree_bodies`
    for ``img``^2 inputs with seeded variables (:func:`random_variables`;
    the camera head at 1/100, so that the camera stays near the mean; the
    heatmap layer at 50x, so that the heatmaps peak and the joints stand
    apart: near-uniform ones put every joint within a few mm and leave the
    IK's bones ill conditioned), those variables, and the port's HybrIK with
    them through ``hybrik_state_from_flax``; and (JAX body, port body, rest
    joints)."""
    from icon_tpu.models.hybrik.net import HybrIK as JHybrIK
    from icon_tpu_torch.models.hybrik.net import HybrIK as PHybrIK
    from icon_tpu_torch.utils.convert import hybrik_state_from_flax
    jbody, pbody, rest = smpl_tree_bodies()
    jnet = JHybrIK(smpl_forward=rotmat_smpl_forward(jbody), rest_joints=rest,
                   parents=SMPL_PARENTS, num_joints=24, num_hm_joints=29,
                   heatmap_size=img // 4, **HYBRIK_NARROW)
    variables = random_variables(jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))), seed)
    params = variables["params"]
    for k in ("kernel", "bias"):
        params["deccam"][k] = params["deccam"][k] * 0.01
    params["final_layer"]["kernel"] = params["final_layer"]["kernel"] * 50
    pnet = PHybrIK(rotmat_smpl_forward(pbody), rest, SMPL_PARENTS,
                   **HYBRIK_NARROW).eval()
    pnet.load_state_dict({k: t(v) for k, v in
                          hybrik_state_from_flax(variables).items()})
    return jnet, variables, pnet, (jbody, pbody, rest)
