"""Port parity, HybrIK (``icon_tpu_torch.models.hybrik``: the ResNet-34, the
deconvs, the 3D-heatmap soft-argmax, the camera back-projection, the fc
heads, the twist-and-swing IK and the SMPL forward) against the JAX
package's ``icon_tpu.models.hybrik`` on the CPU.

Narrow widths (ResNet width 8 with one block a stage, deconvs of 32, a
64^2 input, 8 x 16 x 16 heatmaps); the JAX variables are drawn from a seed
on the ``jax.eval_shape`` tree (the camera head at 1/100, so that the
camera stays near the mean, the heatmap layer at 50x, so that the joints
stand apart: ``torch_port_helpers.hybrik_pair``) and reach the port through
``utils/convert.py:hybrik_state_from_flax``. The body is the 24-joint
synthetic SMPL with SMPL's kinematic tree, whose root and spine have three
children: their Procrustes problems are well posed, and each SVD's
singular values are asserted apart. Compared, each to 1e-5 of the array's
largest magnitude: uvd, xyz, phi, shape, camera, the IK's rotation
matrices and the vertices; the IK alone on seeded skeletons. On the
synthetic SMPL's own chain tree (the root has one child, so the SVD leaves
its twist free) the IK's swings are held to the bones they solve for.

The published widths' layout is held leaf for leaf (``jax.eval_shape``);
the port's state written in the published layout (with the SMPL-layer
buffers and ``init_cam`` the loaders drop) loads into a NaN-filled JAX tree
with every leaf written; the port's loader raises on a missing, an
unexpected and a misshapen tensor; the wrapper's 224 -> 256 resize equals
``jax.image.resize(..., "bilinear")``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (HYBRIK_NARROW as NARROW, SMPL_PARENTS,
                                hybrik_pair, nan_variables, rel_err,
                                rotmat_smpl_forward as _smpl,
                                smpl_tree_bodies, t, unwritten_leaves)

from icon_tpu.models.hybrik.ik import hybrik_ik as jik
from icon_tpu.models.hybrik.net import HybrIK as JHybrIK
from icon_tpu_torch.models.hybrik import ik as P_ik
from icon_tpu_torch.models.hybrik.net import HybrIK as PHybrIK
from icon_tpu_torch.utils.convert import hybrik_state_from_flax

RTOL = 1e-5               # of each array's largest magnitude
IMG = 64
SV_GAP = 1e-2             # least gap of a Procrustes SVD's singular values


@pytest.fixture(scope="module")
def bodies():
    return smpl_tree_bodies()


def _jnet(jbody, rest):
    return JHybrIK(smpl_forward=_smpl(jbody), rest_joints=rest,
                   parents=SMPL_PARENTS, num_joints=24, num_hm_joints=29,
                   heatmap_size=IMG // 4, **NARROW)


def _shapes(net, img=IMG):
    return jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, img, img, 3))))


@pytest.fixture
def svd_gaps(monkeypatch):
    """The relative gaps of the singular values of every Procrustes the
    port's IK solves while the fixture is active."""
    gaps = []
    solve = P_ik._procrustes

    def record(targets, templates):
        M = torch.einsum("bkc,bkd->bcd", targets, templates)
        s = torch.linalg.svdvals(M)
        gaps.append(float(((s[:, :-1] - s[:, 1:]) / s[:, :1]).min()))
        return solve(targets, templates)
    monkeypatch.setattr(P_ik, "_procrustes", record)
    return gaps


def test_hybrik_matches_jax(svd_gaps):
    jnet, variables, pnet, _ = hybrik_pair(IMG)
    x = np.random.RandomState(6).randn(2, IMG, IMG, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jnet.apply(v, x))(variables, x)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    for k in want:
        err = rel_err(got[k], want[k])
        assert err <= RTOL, (k, err)
    assert svd_gaps and min(svd_gaps) > SV_GAP, svd_gaps
    uvd = np.asarray(want["pred_uvd_jts"])
    assert uvd.std(axis=1).min() > 0.03        # the joints are apart


def _skeleton(rng, rest, parents, twist=0.6):
    """A posed skeleton of the rest joints (seeded joint rotations) and
    seeded twists."""
    from icon_tpu_torch.models.smplx.lbs import batch_rodrigues
    R = batch_rodrigues(t(0.5 * rng.randn(2 * 24, 3), torch.float32)
                        ).reshape(2, 24, 3, 3)
    pos = [None] * 24
    glob = [None] * 24
    for i in range(24):
        if i == 0:
            glob[0], pos[0] = R[:, 0], t(rest[None, 0]).expand(2, 3)
            continue
        p = parents[i]
        glob[i] = glob[p] @ R[:, i]
        pos[i] = pos[p] + torch.einsum("bij,j->bi", glob[p],
                                       t(rest[i] - rest[p]))
    skel = torch.stack(pos, 1).numpy()
    phis = np.stack([np.cos(twist * rng.randn(2, 23)),
                     np.sin(twist * rng.randn(2, 23))], -1)
    return (skel - skel[:, :1]).astype(np.float32), phis.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ik_matches_jax(bodies, svd_gaps, seed):
    """The IK alone on seeded skeletons of the SMPL tree: the rotations to
    1e-5, every Procrustes well posed."""
    _, _, rest = bodies
    skel, phis = _skeleton(np.random.RandomState(seed), rest, SMPL_PARENTS)
    rest_b = np.broadcast_to(rest, (2, 24, 3)).copy()
    want = jik(jnp.asarray(skel), jnp.asarray(phis), jnp.asarray(rest_b),
               SMPL_PARENTS)
    got = P_ik.hybrik_ik(t(skel), t(phis), t(rest_b), SMPL_PARENTS)
    assert rel_err(got, want) <= RTOL
    assert min(svd_gaps) > SV_GAP, svd_gaps
    RtR = got.transpose(-1, -2) @ got
    np.testing.assert_allclose(RtR.numpy(), np.broadcast_to(
        np.eye(3), RtR.shape), atol=1e-5)
    assert float(P_ik.bone_alignment(got, t(skel), t(rest_b),
                                     SMPL_PARENTS).min()) > 1 - 1e-5


def test_ik_swings_on_a_chain():
    """The synthetic SMPL's own tree is a chain: its root has one child, so
    its Procrustes leaves the twist about that bone to the SVD (the JAX
    package's too). Whatever twist is chosen, every rotation is proper and
    every swing puts the rest bone on the bone solved for."""
    from icon_tpu_torch.models.pymaf.net import _synthetic_smpl24 as p24
    body = p24(subdiv=2)
    rest = (body.J_regressor @ body.v_template).numpy()
    skel, phis = _skeleton(np.random.RandomState(3), rest, body.parents)
    rest_b = t(np.broadcast_to(rest, (2, 24, 3)).copy())
    R = P_ik.hybrik_ik(t(skel), t(phis), rest_b, body.parents)
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
    assert float(P_ik.bone_alignment(R, t(skel), rest_b,
                                     body.parents).min()) > 1 - 1e-5


def test_published_layout_matches(bodies):
    """At the published widths (ResNet-34, deconvs of 256, 29 x 64 heatmap
    channels) the JAX HybrIK's variables through ``hybrik_state_from_flax``
    give the port's state dict name for name and shape for shape."""
    jbody, _, rest = bodies
    jnet = JHybrIK(smpl_forward=_smpl(jbody), rest_joints=rest,
                   parents=tuple(jbody.parents))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   _shapes(jnet, img=256))
    want = hybrik_state_from_flax(zeros)
    with torch.device("meta"):
        got = PHybrIK(None, rest, jbody.parents).state_dict()
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in got)
    assert tuple(got["final_layer.weight"].shape) == (29 * 64, 256, 1, 1)


DROPPED = {"init_cam": torch.tensor([0.9, 0.0, 0.0]),
           "smpl.v_template": torch.zeros(6890, 3),
           "smpl.J_regressor_h36m": torch.zeros(17, 6890),
           "smpl.children_map": torch.zeros(24, dtype=torch.long)}


@pytest.fixture(scope="module")
def seeded_file(bodies, tmp_path_factory):
    """A narrow port HybrIK's state, BatchNorm statistics, scales and
    biases drawn from a seed, in the published layout under ``module.``
    with the entries the loaders drop."""
    _, pbody, rest = bodies
    torch.manual_seed(7)
    net = PHybrIK(_smpl(pbody), rest, SMPL_PARENTS, **NARROW)
    rng = np.random.RandomState(7)
    state = {k: (v if v.dtype == torch.int64 else v + t(
        0.1 * rng.randn(*v.shape), torch.float32).abs())
        for k, v in net.state_dict().items()}
    path = str(tmp_path_factory.mktemp("hybrik") / "pretrained_w_cam.pth")
    torch.save({"module." + k: v for k, v in {**state, **DROPPED}.items()},
               path)
    return path, state


def test_jax_loader_writes_every_leaf(bodies, seeded_file, capsys):
    """The JAX package's ``load_hybrik_checkpoint`` on the port's file
    fills a NaN tree completely; the port's loader reads it strictly,
    naming the four dropped entries."""
    from icon_tpu.models.hybrik.convert import load_hybrik_checkpoint as jl
    from icon_tpu_torch.models.hybrik.convert import load_hybrik_checkpoint
    jbody, pbody, rest = bodies
    path, state = seeded_file
    variables = jl(nan_variables(_shapes(_jnet(jbody, rest))), path)
    assert unwritten_leaves(variables) == []
    back = hybrik_state_from_flax(variables)
    net = load_hybrik_checkpoint(
        PHybrIK(_smpl(pbody), rest, SMPL_PARENTS, **NARROW), path)
    assert "dropped 4 entries" in capsys.readouterr().out
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), k)
        np.testing.assert_array_equal(back[k], state[k].numpy(), k)


def test_loader_is_strict(bodies, seeded_file, tmp_path):
    from icon_tpu_torch.models.hybrik.convert import load_hybrik_checkpoint
    _, pbody, rest = bodies
    path, state = seeded_file

    def load(s):
        p = str(tmp_path / "x.pth")
        torch.save(s, p)
        return load_hybrik_checkpoint(
            PHybrIK(_smpl(pbody), rest, SMPL_PARENTS, **NARROW), p)

    with pytest.raises(KeyError, match="lacks 1 HybrIK tensors"):
        load({k: v for k, v in state.items() if k != "init_shape"})
    with pytest.raises(KeyError, match="no place"):
        load({**state, "fc3.weight": torch.zeros(3, 3)})
    with pytest.raises(RuntimeError, match="size mismatch"):
        load({**state, "decphi.bias": torch.zeros(44)})


def test_wrapper_resize_matches_jax(monkeypatch):
    """``HybrIKWrapper`` resizes the dataset's 224^2 input to 256^2 as the
    JAX wrapper's ``jax.image.resize(..., "bilinear")``."""
    from icon_tpu_torch.data.test_dataset import HybrIKWrapper
    w = HybrIKWrapper(device="cpu")
    monkeypatch.setattr(w, "net", lambda x: {"x": x})
    img = np.random.RandomState(8).randn(1, 224, 224, 3).astype(np.float32)
    got = w(torch.from_numpy(img))["x"].permute(0, 2, 3, 1)
    want = jax.image.resize(jnp.asarray(img), (1, 256, 256, 3), "bilinear")
    assert rel_err(got, want) <= RTOL
