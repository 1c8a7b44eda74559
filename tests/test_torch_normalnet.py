"""Port parity, the NormalNet: the pix2pixHD layers (instance norm, reflect
pad, the torch-layout transposed conv), GlobalGenerator, NormalNet,
``predict_normals`` and ``filter()`` without normal maps, against the flax
modules with the same weights moved by state_dict_from_flax; and the state
dict's layout against a generator built to the reference's spec.

Layers to 1e-5 absolute, like the ops; the generators and everything
downstream of them to 1e-4, the bar of the other network parity tests
(deep float32 conv stacks summed in another order)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port import torch_global_generator
from torch_port_helpers import (init_jax_icon, normalnet_cfg, port_cfg,
                                port_state, t)

from icon_tpu_torch.models.hgpifu import HGPIFuNet
from icon_tpu_torch.models.layers import (conv_transpose2x, make_norm,
                                          reflect_pad2d)
from icon_tpu_torch.models.pix2pix import GlobalGenerator
from icon_tpu_torch.utils.convert import generator_state

ATOL = 1e-4
RNG = np.random.RandomState(5)


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _instance_norms(x):
    """(JAX, port, float64) instance norms of NHWC ``x``."""
    from icon_tpu.models.layers import make_norm as jmake_norm
    jm = jmake_norm("instance", "n")
    ref = jm.apply(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                   jnp.asarray(x))
    norm = make_norm("instance", x.shape[-1])
    assert not norm.affine and not norm.track_running_stats
    with torch.no_grad():
        out = nhwc(norm(nchw(x)))
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean((1, 2), keepdims=True)) / np.sqrt(
        x64.var((1, 2), keepdims=True) + 1e-5)
    return np.asarray(ref), out, exact


def test_instance_norm_parity():
    x = (RNG.randn(2, 9, 7, 16) * 2.0 + RNG.randn(16)).astype(np.float32)
    ref, out, _ = _instance_norms(x)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_instance_norm_at_the_bottleneck():
    """At the 512^2 generator's bottleneck (1,024 channels at 32^2) with
    channel means of the size seeded weights give there (|mean| / std up to
    ~2), flax's GroupNorm(group_size=1) computes the variance as
    E[x^2] - E[x]^2 and loses up to ~1.5e-5 to cancellation; InstanceNorm2d
    stays within 1e-6 of float64. The port is held to float64, and its
    distance to the JAX module to the JAX module's own error plus 1e-6."""
    x = ((RNG.randn(1, 32, 32, 1024) + 0.8 * RNG.randn(1024)) *
         RNG.uniform(0.5, 2.0, 1024)).astype(np.float32)
    ref, out, exact = _instance_norms(x)
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-6)
    jax_err = float(np.abs(ref - exact).max())
    assert float(np.abs(out - ref).max()) <= jax_err + 1e-6
    assert jax_err < 5e-5


def test_reflect_pad_parity():
    from icon_tpu.models.layers import reflect_pad2d as jpad
    x = RNG.randn(2, 6, 5, 3).astype(np.float32)
    for pad in (1, 3):
        np.testing.assert_array_equal(nhwc(reflect_pad2d(pad)(nchw(x))),
                                      np.asarray(jpad(jnp.asarray(x), pad)))


def test_conv_transpose_parity():
    """ConvTranspose2d(k3, s2, p1, op1) against ConvTranspose2dTorch: an
    exact 2x upsample, whose kernel comes back from flax's transposed
    layout with no spatial flip."""
    from icon_tpu.models.layers import ConvTranspose2dTorch
    x = RNG.randn(1, 5, 6, 16).astype(np.float32)
    jm = ConvTranspose2dTorch(8)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = variables["params"]["tconv"]
    bias = RNG.randn(8).astype(np.float32)
    ref = jm.apply({"params": {"tconv": {"kernel": p["kernel"],
                                         "bias": bias}}}, jnp.asarray(x))
    m = conv_transpose2x(16, 8)
    m.load_state_dict({"weight": t(np.transpose(np.asarray(p["kernel"]),
                                                (3, 2, 0, 1))),
                       "bias": t(bias)})
    with torch.no_grad():
        out = m(nchw(x))
    assert out.shape == (1, 8, 10, 12)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=0, atol=1e-5)


def _randomized_bias(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32) if path[-1].key == "bias" else np.asarray(a), tree)


@pytest.mark.parametrize("ngf,n_down,n_blocks", [(8, 2, 2), (64, 4, 9)])
def test_global_generator_parity(ngf, n_down, n_blocks):
    """Narrow, and at the published widths (ngf 64, 4 downsamplings, 9
    blocks), at 64^2."""
    from icon_tpu.models.pix2pix import GlobalGenerator as JGenerator
    x = RNG.randn(1, 64, 64, 6).astype(np.float32)
    jm = JGenerator(ngf=ngf, n_downsampling=n_down, n_blocks=n_blocks)
    params = _randomized_bias(
        jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], RNG)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = GlobalGenerator(6, ngf=ngf, n_downsampling=n_down,
                        n_blocks=n_blocks)
    m.load_state_dict({k: t(v) for k, v in generator_state(params).items()})
    del params
    with torch.no_grad():
        out = nhwc(m(nchw(x)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    assert out.std() > 0.05


@pytest.fixture(scope="module")
def normal_pair():
    cfg = normalnet_cfg()
    jnet, variables = init_jax_icon(cfg, seed=2, normal_net=True)
    net = HGPIFuNet(port_cfg(cfg))
    net.load_state_dict(port_state(variables))            # strict
    return jnet, variables, net.eval()


def _normal_inputs():
    image = RNG.randn(1, 64, 64, 3).astype(np.float32)
    image[0, :12] = 0.0                 # background rows: masked out
    image[0, 40:44] = 0.0
    return {"image": image,
            "T_normal_F": RNG.randn(1, 64, 64, 3).astype(np.float32),
            "T_normal_B": RNG.randn(1, 64, 64, 3).astype(np.float32)}


def test_predict_normals_parity(normal_pair):
    """NormalNet and predict_normals: unit normals inside the image mask,
    zeros outside; compared to 1e-4 where the generator's raw output norm
    exceeds 1e-3 (the division amplifies the generators' difference there);
    the excluded pixels are counted."""
    jnet, variables, net = normal_pair
    inp = _normal_inputs()
    ref = jnet.apply(variables, {k: jnp.asarray(v) for k, v in inp.items()},
                     False, method=jnet.predict_normals)
    with torch.no_grad():
        out = net.predict_normals({k: t(v) for k, v in inp.items()})
        raw = [nhwc(g(nchw(np.concatenate([inp["image"], inp[k]], -1))))
               for g, k in ((net.normal_filter.netF, "T_normal_F"),
                            (net.normal_filter.netB, "T_normal_B"))]
    mask = np.abs(inp["image"]).sum(-1) != 0
    for o, r, g in zip(out, ref, raw):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == (1, 64, 64, 3)
        np.testing.assert_array_equal(o[~mask], 0.0)
        norm = np.linalg.norm(g, axis=-1)
        keep = mask & (norm > 1e-3)
        assert (mask & ~keep).sum() <= 0.01 * mask.sum()
        np.testing.assert_allclose(o[keep], r[keep], rtol=0, atol=ATOL)
        np.testing.assert_allclose(np.linalg.norm(o[keep], axis=-1), 1.0,
                                   atol=1e-5)


def test_filter_predicts_missing_normals(normal_pair):
    """filter() without normal_F/normal_B equals filter() given
    predict_normals' output, and the JAX filter on the same input."""
    jnet, variables, net = normal_pair
    inp = _normal_inputs()
    ref = jnet.apply(variables, {k: jnp.asarray(v) for k, v in inp.items()},
                     False, method=jnet.filter)[-1]
    with torch.no_grad():
        tin = {k: t(v) for k, v in inp.items()}
        feats = net.filter(tin)[-1]
        nml_f, nml_b = net.predict_normals(tin)
        given = net.filter({"normal_F": nml_f, "normal_B": nml_b})[-1]
    np.testing.assert_array_equal(feats.numpy(), given.numpy())
    assert feats.shape == (1, 16, 16, 12)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    no_nml = HGPIFuNet(port_cfg(normalnet_cfg()), normal_net=False)
    with pytest.raises(ValueError, match="normal_net=False"):
        no_nml.filter(tin)


def test_state_dict_is_the_published_layout(normal_pair):
    """The port's normal_filter.netF.model.* keys and shapes are those of a
    generator built to the reference's spec (block renamed conv_block), at
    the published widths; a state dict of that twin loads strictly and
    reproduces its forward."""
    _, _, net = normal_pair
    twin = torch_global_generator(input_nc=6, ngf=8, n_down=2, n_blocks=2)
    ref_sd = {"model." + k.replace(".block.", ".conv_block."): v
              for k, v in twin.state_dict().items()}
    ours = {k[len("normal_filter.netF."):]: v
            for k, v in net.state_dict().items()
            if k.startswith("normal_filter.netF.")}
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref_sd.items()}

    with torch.device("meta"):
        full = GlobalGenerator(6)
        full_twin = torch_global_generator(input_nc=6, ngf=64, n_down=4,
                                           n_blocks=9)
    keys = {"model." + k.replace(".block.", ".conv_block.")
            for k in full_twin.state_dict()}
    assert set(full.state_dict()) == keys
    for idx in (1, 4, 7, 10, 13, 25, 28, 31, 34, 38):
        assert f"model.{idx}.weight" in keys
    assert {f"model.{j}.conv_block.{s}.weight" for j in range(16, 25)
            for s in (1, 5)} <= keys

    gen = copy.deepcopy(net.normal_filter.netF)
    gen.load_state_dict(ref_sd, strict=True)
    x = RNG.randn(1, 6, 32, 32).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_array_equal(gen.eval()(t(x)).numpy(),
                                      twin.eval()(t(x)).numpy())
