"""Port parity, the U^2-Net matting net (``icon_tpu_torch.models.u2net``)
against the JAX package's ``icon_tpu.models.u2net`` on the CPU, at the
segmenter's 320^2 input, for the lite (u2netp) and the full (u2net)
configuration at their published widths.

The port's seeded state dict (``utils/synthetic.py:seeded_u2net_state``,
the public checkpoint's layout, BatchNorm statistics and affine drawn from
a seed, the fuse conv's bias at 0 so the matte is not saturated) goes into
the JAX tree through the JAX package's own ``port_u2net``. That converter
skips silently what it cannot place, so every leaf of the JAX tree starts
as NaN and must have been written. Then the fused matte to 1e-5; the whole
segmenter (host pre- and post-processing included) on a seeded crop
loaded from one ``.pth`` by both packages: at most one uint8 step (1/255)
apart, on at most 1% of the pixels."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icon_tpu.models import u2net as JU
from icon_tpu_torch.models import u2net as PU
from icon_tpu_torch.utils.synthetic import seeded_u2net_state

ALPHA_ATOL = 1e-5


def _state(lite: bool, seed: int = 0):
    state = seeded_u2net_state(lite, seed)
    state["outconv.bias"] = torch.zeros(1)
    return state


def _jax_variables(net, state):
    """``state`` ported by ``port_u2net`` into a JAX tree of NaN leaves;
    asserts that no leaf is left unwritten."""
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 320, 320, 3)), train=False))
    nan = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, np.nan, np.float32), shapes)
    new = JU.port_u2net({k: v.numpy() for k, v in state.items()}, nan)
    leaves = jax.tree_util.tree_leaves_with_path(new)
    unwritten = [jax.tree_util.keystr(p) for p, a in leaves
                 if np.isnan(a).any()]
    assert not unwritten, unwritten[:5]
    # every torch tensor but the step counters has its leaf
    assert len(leaves) == sum(not k.endswith("num_batches_tracked")
                              for k in state)
    return new


@pytest.mark.parametrize("lite", [True, False], ids=["lite", "full"])
def test_u2net_matches_jax(lite):
    state = _state(lite)
    cfg = (JU.U2NET_LITE, PU.U2NET_LITE) if lite else \
        (JU.U2NET_FULL, PU.U2NET_FULL)
    jnet = JU.U2NET(config=cfg[0])
    variables = _jax_variables(jnet, state)
    pnet = PU.U2NET(cfg[1])
    pnet.load_state_dict(state, strict=True)
    pnet.eval()
    x = np.random.RandomState(1).randn(1, 320, 320, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, x))
    with torch.no_grad():
        got = pnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 320, 320, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ALPHA_ATOL)
    assert want.std() > 1e-3                      # not a saturated matte


def test_segmenter_matches_jax(tmp_path):
    """One ``u2netp.pth`` loaded by each package's ``build_segmenter``;
    the alpha of a seeded odd-sized crop through both hosts' PIL paths."""
    path = str(tmp_path / "u2netp.pth")
    torch.save(_state(True, seed=3), path)
    rgb = np.random.RandomState(2).rand(150, 97, 3).astype(np.float32)
    got = PU.build_segmenter(path, lite=True, device="cpu")(rgb)
    want = JU.build_segmenter(path, lite=True)(rgb)
    assert got.shape == want.shape == (150, 97) and got.dtype == want.dtype
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 / 255 + 1e-7
    assert (diff > 0).mean() <= 0.01
    assert want.std() > 1e-3


def test_build_segmenter_is_strict(tmp_path):
    with pytest.raises(FileNotFoundError):
        PU.build_segmenter(str(tmp_path / "absent.pth"), device="cpu")
    state = _state(True)
    state["side7.weight"] = torch.zeros(1)
    bad = str(tmp_path / "bad.pth")
    torch.save(state, bad)
    with pytest.raises(RuntimeError, match="side7"):
        PU.build_segmenter(bad, lite=True, device="cpu")
    with pytest.raises(RuntimeError):          # a lite file, a full net
        torch.save(_state(True), bad)
        PU.build_segmenter(bad, lite=False, device="cpu")
