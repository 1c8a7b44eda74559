"""Port parity, whole train steps: one and three steps of
icon_tpu_torch's ``train_step`` from a converted JAX ``TrainState`` against
the JAX package's ``train_step``, on the JAX package's fixture (2 subjects,
2 views, 32^2, visibility at 128^2) written once for the module.

The JAX step runs eagerly, each of its operations jitted: under one jit XLA
ranks tied candidate faces of the body features differently (Queue C "the
body features jump"), and the eager step is the one the port matches.

Tolerances: the first loss to 1e-5 relative and the gradients to 1e-2 of
each tensor's largest (the hourglass's float32 convolutions summed in
another order; a bias that feeds a normalization, whose gradient is 0 but
for rounding, to 1e-6 of the largest gradient of all). After a step a
parameter may differ by up to the optimizer's largest move where its
gradient is at rounding level (RMSprop's |u| <= lr / sqrt(1 - 0.9), Adam's
the same 3.16 lr), so the later losses to 2e-3 relative, every parameter
within twice that move a step, each tensor's median difference to 5e-5, the
BatchNorm statistics to 2e-3, and the optimizer state's median difference
to 1e-3 of its largest magnitude after one step, 2e-2 after three.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torch_port_helpers import port_cfg, t
from test_torch_train import OPTIMS, _jax_state, _port_from_jax, jax_cfg

SIZE, VIEWS = 32, 2


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from icon_tpu.data.fixture import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp("jax_fixture"))
    make_synthetic_dataset(root, n_subjects=2, n_views=VIEWS, size=SIZE,
                           vis_res=128)
    return root


def _batch(cfg):
    from icon_tpu.data.datasets import DataLoader, PIFuDataset
    nb = next(iter(DataLoader(PIFuDataset(cfg), batch_size=2,
                              shuffle=False, num_workers=1)))
    arrays = {k: v for k, v in nb.items() if isinstance(v, np.ndarray)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: t(v) for k, v in arrays.items()})


def _largest_move(cfg, steps):
    """How far the two packages' parameters may drift apart in ``steps``
    where a gradient is at rounding level: each may move by RMSprop's
    lr / sqrt(1 - 0.9) (Adam's lr (1 - b1) / sqrt(1 - b2), the same 3.16
    lr) a step, momentum summing those moves, in either direction."""
    per_step = cfg.lr_G / np.sqrt(0.1)
    if cfg.momentum:
        per_step /= 1.0 - cfg.momentum
    return 1.01 * 2 * steps * per_step


def _check_state(net, opt, state, cfg, steps, gauge):
    """``gauge``: the parameters whose gradient is at rounding level (a
    bias that feeds a normalization); their values and optimizer state are
    rounding noise amplified by the update rule, held to the move bound
    alone. The optimizer state's median difference to 1e-3 of its largest
    after one step (one gradient apart), 2e-2 after more (gradients taken
    at parameters already apart)."""
    state_rtol = 1e-3 if steps == 1 else 2e-2
    from icon_tpu_torch.utils.convert import (_optax_leaves,
                                              state_dict_from_flax)
    want = state_dict_from_flax(*jax.device_get((state.params,
                                                 state.batch_stats)))
    got = net.state_dict()
    names = dict(net.named_parameters())
    bound = _largest_move(cfg, steps)
    for k, v in want.items():
        d = np.abs(got[k].numpy() - v)
        if "running" in k:
            assert d.max() <= 2e-3, k
        elif k in names:
            assert d.max() <= bound, (k, d.max(), bound)
            assert k in gauge or np.median(d) <= 5e-5, (k, np.median(d))
    found = {}
    _optax_leaves(jax.device_get(state.opt_state), found)
    assert found["count"] == opt.count == steps
    for kind in ("nu", "mu", "trace"):
        if kind not in found:
            continue
        ref = state_dict_from_flax(found[kind])
        for k, p in opt.state.items():
            if k in ref and "bn4" not in k and k not in gauge:
                d = np.abs(p[kind].numpy() - ref[k])
                scale = max(float(np.abs(ref[k]).max()), 1e-12)
                assert np.median(d) <= state_rtol * scale, (kind, k)


@pytest.mark.parametrize("steps,name", [(1, "rmsprop"),
                                        (3, "rmsprop-momentum"),
                                        (3, "adam")])
def test_train_steps_match(fixture_root, steps, name):
    """One or three steps of ``train_step`` from a converted JAX state
    against the JAX package's, the schedule boundary after step 2, weight
    decay on: the loss per step, the gradients of the first, the
    parameters, BatchNorm statistics and optimizer state after."""
    from icon_tpu.training.train_step import train_step as jstep
    from icon_tpu_torch.training.train_step import train_step
    cfg = jax_cfg(fixture_root, schedule=(1,), weight_decay=1e-4,
                  **OPTIMS[name])
    jb, pb = _batch(cfg)
    state = _jax_state(cfg, jb, steps_per_epoch=2)
    net, opt = _port_from_jax(cfg, state, steps_per_epoch=2)

    # the first step's gradients against jax.grad of the same loss
    from icon_tpu.models.hgpifu import HGPIFuNet as JNet
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    jnet = JNet(cfg)
    jg = jax.grad(lambda p: jnet.apply(
        {"params": p, "batch_stats": state.batch_stats}, jb, train=True,
        mutable=["batch_stats"])[0][1])(state.params)
    twin = copy.deepcopy(net).train()      # keeps net's running stats
    twin(pb)[1].backward()
    grads = {k: (dict(twin.named_parameters())[k].grad.numpy(), g)
             for k, g in state_dict_from_flax(jax.device_get(jg)).items()
             if dict(twin.named_parameters()).get(k) is not None
             and "bn4" not in k}
    top = max(float(np.abs(g).max()) for _, g in grads.values())
    gauge = {k for k, (_, g) in grads.items()
             if float(np.abs(g).max()) <= 1e-6 * top}
    assert gauge <= {"if_regressor.filters.0.bias", "F_filter.conv1.bias",
                     "F_filter.conv_last0.bias"}
    for k, (got, g) in grads.items():
        scale = float(np.abs(g).max())
        if k not in gauge:
            np.testing.assert_allclose(got, g, rtol=0, atol=1e-2 * scale,
                                       err_msg=k)
        else:           # a bias feeding a normalization: exactly 0 in theory
            np.testing.assert_allclose(got, g, rtol=0, atol=1e-6 * top,
                                       err_msg=k)

    for step in range(steps):
        state, jm = jstep(state, jb)
        pm = train_step(net, opt, pb)
        rtol = 1e-5 if step == 0 else 2e-3
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=rtol)
    _check_state(net, opt, state, port_cfg(cfg), steps, gauge)
