"""Port parity, PARE (``icon_tpu_torch.models.pare``: the HRNet-conv
backbone, the part-attention head, the SMPL forward) against the JAX
package's ``icon_tpu.models.pare`` on the CPU, on the 24-joint synthetic
SMPL: a narrow HRNet (width 8, one module per stage, 64^2 input) and the
published HRNet-W32 at 224^2.

The port's seeded state dict (BatchNorm statistics, scales and biases
drawn from a seed) is saved as a Lightning checkpoint in the published
layout (``state_dict`` under ``model.``, with SMPL, ``init_pose`` and
``final_layer`` entries that both loaders drop) and loaded by the JAX
package's ``load_pare_checkpoint`` into a tree of NaN leaves: every leaf
must be written but ``head/pose_mlp/bias``, which the reference's
LocallyConnected2d does not have (set to 0, its init). The port loads the
same file strictly. Then ``pred_pose``, ``pred_shape``, ``pred_cam``,
``smpl_vertices`` and the part segmentation to 1e-5 of each array's
largest magnitude."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icon_tpu.models.pare.convert import load_pare_checkpoint as jload
from icon_tpu.models.pare.net import PARE as JPARE
from icon_tpu.models.pymaf.net import _synthetic_smpl24
from icon_tpu_torch.models.pare.convert import load_pare_checkpoint
from icon_tpu_torch.models.pare.net import PARE as PPARE
from icon_tpu_torch.utils.convert import body_model_from_jax

RTOL = 1e-5               # of each array's largest magnitude
DROPPED = {"model.head.smpl.v_template": torch.zeros(6890, 3),
           "model.head.init_pose": torch.zeros(1, 144),
           "model.backbone.final_layer.weight": torch.zeros(24, 32, 1, 1)}


@pytest.fixture(scope="module")
def bodies():
    jbody = _synthetic_smpl24(subdiv=2)
    return jbody, body_model_from_jax(jbody)


def _forward(body, pose2rot=False):
    def fwd(betas, rotmats):
        return body.forward(
            betas=betas, global_orient=rotmats[:, :1].reshape(-1, 9),
            body_pose=rotmats[:, 1:].reshape(rotmats.shape[0], -1),
            pose2rot=pose2rot)
    return fwd


def _seeded_state(net, rng):
    state = net.state_dict()
    for k, v in state.items():
        if k.endswith("running_mean"):
            v = 0.1 * rng.randn(*v.shape)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith(".bias") or (k.endswith(".weight") and v.ndim == 1):
            v = v.numpy() + 0.1 * rng.randn(*v.shape)
        else:
            continue
        state[k] = torch.from_numpy(np.asarray(v, np.float32))
    # small 6D outputs: the rotations then depend on every feature
    state["head.pose_mlp.weight"] = state["head.pose_mlp.weight"] * 0.05
    return state


@pytest.mark.parametrize("width, stages, img", [
    (8, (1, 1, 1), 64), (32, (1, 4, 3), 224)], ids=["w8", "w32"])
def test_pare_matches_jax(bodies, tmp_path, capsys, width, stages, img):
    jbody, pbody = bodies
    rng = np.random.RandomState(width)
    torch.manual_seed(width)
    src = PPARE(_forward(pbody), width, stages).eval()
    path = str(tmp_path / "pare_checkpoint.ckpt")
    torch.save({"state_dict": {**{"model." + k: v for k, v in
                                  _seeded_state(src, rng).items()},
                               **DROPPED}, "epoch": 1}, path)

    pnet = PPARE(_forward(pbody), width, stages).eval()
    load_pare_checkpoint(pnet, path)
    assert "dropped 3 entries" in capsys.readouterr().out
    jnet = JPARE(smpl_forward=_forward(jbody), backbone_width=width,
                 stage_modules=stages)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))
    variables = jload(jax.tree_util.tree_map(
        lambda a: np.full(a.shape, np.nan, np.float32), shapes), path)
    unwritten = [jax.tree_util.keystr(p) for p, a in
                 jax.tree_util.tree_leaves_with_path(variables)
                 if np.isnan(a).any()]
    assert unwritten == ["['params']['head']['pose_mlp']['bias']"]
    bias = variables["params"]["head"]["pose_mlp"]["bias"]
    variables["params"]["head"]["pose_mlp"]["bias"] = np.zeros_like(bias)

    x = (rng.randn(1, img, img, 3) * 0.5).astype(np.float32)
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x))
    for k in ("pred_pose", "pred_shape", "pred_cam", "smpl_vertices",
              "smpl_joints2d", "pred_segm_mask"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= RTOL * float(np.abs(w).max()), (k, err)
    assert float(np.abs(np.asarray(want["pred_shape"])).max()) > 1e-2


def test_loader_is_strict(bodies, tmp_path):
    _, pbody = bodies
    net = PPARE(_forward(pbody), 8, (1, 1, 1))
    state = {"model." + k: v for k, v in net.state_dict().items()
             if not k.startswith("head.cam_mlp")}
    path = str(tmp_path / "partial.ckpt")
    torch.save({"state_dict": state}, path)
    with pytest.raises(KeyError, match="lacks 2 PARE tensors"):
        load_pare_checkpoint(net, path)
    state = {"module." + k: v for k, v in net.state_dict().items()}
    state["module.head.cam_mlp.bias"] = torch.zeros(4)
    torch.save(state, path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_pare_checkpoint(net, path)
