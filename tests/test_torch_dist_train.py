"""Port parity, data-parallel training steps under 2 gloo CPU ranks, on the
JAX package's fixture (2 subjects, 2 views, 32^2, visibility at 128^2).

The global batch holds the 4 items; each rank steps on its contiguous 2.
From the same converted JAX state, 2 SGD steps (as tests/test_dist.py:218
takes them: the collectives under test do not depend on the optimizer,
and RMSprop's 1/sqrt(nu) turns rounding into whole steps) of

- the port's 2 ranks (gradients averaged in one all-reduce, BatchNorm on
  the global moments),
- the port's one process on the global batch,
- the JAX package's eager ``train_step`` on the global batch (eager as in
  tests/test_torch_train_steps.py: under one jit XLA picks other faces
  among equidistant ones for the body features),

for the icon and the pamir prior. Tolerances: the losses to 1e-5 relative
at the first step, 1e-4 at the second; the parameters and BatchNorm
statistics to tests/test_dist.py:218's atol 1e-5, rtol 1e-4, the same on
both ranks.

The ranks run while this process takes the reference steps, and are
joined with a timeout of their own; no child is left after them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_dist_ranks import Ranks, train_steps
from torch_port_helpers import port_cfg
from test_torch_train import _jax_state, _port_from_jax, jax_cfg

SIZE, VIEWS, STEPS = 32, 2, 2


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from icon_tpu.data.fixture import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp("jax_fixture"))
    make_synthetic_dataset(root, n_subjects=2, n_views=VIEWS, size=SIZE,
                           vis_res=128)
    return root


def _close(got, want, what):
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):       # flax keeps no count
            continue
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("prior", ["icon", "pamir"])
def test_train_steps_two_ranks(fixture_root, tmp_path, prior):
    from icon_tpu.data.datasets import DataLoader, PIFuDataset
    from icon_tpu.training.train_step import train_step as jstep
    from icon_tpu_torch.training.train_step import train_step
    from icon_tpu_torch.utils.convert import state_dict_from_flax
    cfg = jax_cfg(fixture_root, prior, optim="SGD")
    nb = next(iter(DataLoader(PIFuDataset(cfg), batch_size=4,
                              shuffle=False, num_workers=1)))
    jb = {k: jnp.asarray(v) for k, v in nb.items()
          if isinstance(v, np.ndarray)}
    state = _jax_state(cfg, jb, steps_per_epoch=2)
    net, opt = _port_from_jax(cfg, state, steps_per_epoch=2)
    pcfg = port_cfg(cfg)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    path = str(tmp_path / "state.pt")
    torch.save({"cfg": pcfg, "state": net.state_dict(),
                "opt": opt.state_dict(), "steps_per_epoch": 2,
                "batch": batch}, path)
    ranks = Ranks(train_steps, (path, STEPS))

    one = [float(train_step(net, opt, batch)["loss"]) for _ in range(STEPS)]
    want = {k: v.numpy() for k, v in net.state_dict().items()}
    jlosses = []
    for _ in range(STEPS):
        state, jm = jstep(state, jb)
        jlosses.append(float(jm["loss"]))
    jwant = state_dict_from_flax(*jax.device_get((state.params,
                                                  state.batch_stats)))

    got = ranks.result()
    for r in got:
        for ref in (one, jlosses):
            np.testing.assert_allclose(r["losses"][0], ref[0], rtol=1e-5)
            np.testing.assert_allclose(r["losses"][1], ref[1], rtol=1e-4)
        _close(r["state"], want, "port one process")
        _close(r["state"], jwant, "JAX")
        assert any("running" in k for k in jwant)
    for k, v in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][k], v, k)
