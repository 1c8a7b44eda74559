"""Port parity, the NormalNet trainer: icon_tpu_torch's VGG19 features and
perceptual loss, ``NormalDataset``, ``normal_pred_panels``, the Adam step
and its schedule, the eval step and the train_normal CLI against the JAX
package, on the CPU.

Tolerances:

- VGG19 at 32^2: each slice's features to 1e-4 of its largest magnitude,
  the perceptual loss to 1e-5 relative (float32 convolutions summed in
  another order);
- dataset items: the five images to one float32 step of the decoded value
  (2.4e-7); the trainer's panels to 1e-4 (the predictions' convolutions);
- the optimizer on identical gradients: parameters and Adam's moments to
  1e-6 relative;
- three Adam steps of a narrow NormalNet (ngf 8, 2 downsamplings, 1
  resblock, batch 2 at 64^2) from the JAX state: the first loss to 1e-5
  relative, the later ones and the eval losses to 1e-4. The conv biases
  ahead of an affine-free InstanceNorm have a true gradient of 0, and
  Adam turns their rounding noise into steps of about ``lr`` either way
  (ROADMAP Queue C, "Adam on noise-level gradients"), so those parameters
  are held to ``2 * lr`` a step, as is every other tensor's largest
  difference: a weight whose gradient is at the level of Adam's ``eps``
  (1e-8) takes such a noise-driven step too. Those steps move the next
  gradients of the rest by ~1e-3 relative, so each other tensor's median
  difference is held to ``PARAM_MEDIAN`` = 1e-2 ``lr`` (3.1e-6 measured,
  netB's input conv after the third step).
"""

import multiprocessing
import os
import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import port_cfg, t

SIZE, VIEWS = 32, 2
LR = 1e-3
PARAM_MEDIAN = 1e-5


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    from icon_tpu_torch.utils.synthetic import write_vgg19
    return write_vgg19(str(tmp_path_factory.mktemp("vgg") / "vgg19.pth"),
                       seed=3, classifier_width=16)


def _jax_vgg(path):
    from icon_tpu.models.vgg import Vgg19Features, port_vgg19
    sd = {k: v.numpy() for k, v in torch.load(path).items()}
    return Vgg19Features().apply, port_vgg19(sd)


def test_vgg_features_and_loss_match(vgg_path, tmp_path):
    from icon_tpu.models.vgg import vgg_perceptual_loss as jloss
    from icon_tpu_torch.models.vgg import load_vgg19, vgg_perceptual_loss
    from icon_tpu_torch.utils.convert import vgg19_state_from_flax
    apply_fn, params = _jax_vgg(vgg_path)
    vgg = load_vgg19(vgg_path)
    assert not any(p.requires_grad for p in vgg.parameters())
    assert load_vgg19(str(tmp_path / "absent.pth")) is None
    for k, v in vgg19_state_from_flax(params).items():
        np.testing.assert_array_equal(v, vgg.state_dict()[k].numpy())
    rng = np.random.RandomState(0)
    x, y = (rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(2))
    want = apply_fn({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = vgg(t(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=1e-4 * np.abs(w).max())
    with torch.no_grad():
        loss = float(vgg_perceptual_loss(vgg, t(x), t(y)))
    want = float(jloss(apply_fn, params, jnp.asarray(x), jnp.asarray(y)))
    assert loss == pytest.approx(want, rel=1e-5)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The port's fixture writer (its files equal the JAX package's,
    tests/test_torch_train.py)."""
    from icon_tpu_torch.data.fixture import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp("normal_fixture"))
    make_synthetic_dataset(root, n_subjects=2, n_views=VIEWS, size=SIZE,
                           vis_res=64, device="cpu")
    return root


def _cfg(root, **over):
    from icon_tpu.data.fixture import fixture_config
    cfg = fixture_config(root, n_views=VIEWS, num_sample_geo=64,
                         image_size=SIZE)
    return cfg.replace(**over)


KEYS = ("image", "T_normal_F", "T_normal_B", "normal_F", "normal_B")


def test_normal_dataset_items_match(fixture_root):
    from icon_tpu.data.datasets import NormalDataset as JD
    from icon_tpu_torch.data.datasets import NormalDataset
    cfg = _cfg(fixture_root)
    jd, pd = JD(cfg), NormalDataset(port_cfg(cfg))
    assert len(jd) == len(pd) == 2 * VIEWS
    for i in range(len(jd)):
        a, b = jd[i], pd[i]
        assert set(a) == set(b) == set(KEYS)
        for k in KEYS:
            assert b[k].shape == (SIZE, SIZE, 3)
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2.4e-7)


def test_prediction_panels_match():
    """The trainer's panels (the first item, predicted in eval mode)
    against the JAX trainer's: ``normal_pred_panels`` of the JAX NormalNet's
    prediction with the same weights, to 1e-4 (deep float32 convolutions
    in another order)."""
    from icon_tpu.models.normalnet import NormalNet as JNet
    from icon_tpu.training.visuals import normal_pred_panels as jpanels
    from icon_tpu_torch.apps.train_normal import prediction_panels
    from icon_tpu_torch.models.normalnet import NormalNet
    from icon_tpu_torch.utils.convert import normal_state_from_flax
    kw = dict(ngf=8, n_downsampling=2, n_blocks=1)
    batch = _batch(np.random.RandomState(1), size=32)
    one = {k: jnp.asarray(v[:1]) for k, v in batch.items()}
    jnet = JNet(**kw)
    params = jax.jit(lambda b: jnet.init(jax.random.PRNGKey(1), b))(one)
    pf, pb = jax.jit(lambda p, b: jnet.apply(p, b, train=False))(params,
                                                                  one)
    want = jpanels(one, pf, pb)
    net = NormalNet(**kw)
    net.load_state_dict({k: t(np.asarray(v)) for k, v in
                         normal_state_from_flax(params["params"]).items()})
    got = prediction_panels(net.train(), {k: t(v) for k, v in
                                          batch.items()})
    assert net.training and list(got) == list(want) == [
        "image", "T_normal_F", "pred_F", "gt_F", "pred_B", "gt_B"]
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-4)


def test_optimizer_matches_optax_adam():
    """Three steps on identical gradients across a schedule boundary (at
    step 2): Adam at ``lr_N`` whatever ``optim``, momentum and weight decay
    the config holds, as the JAX step's ``optax.adam``."""
    import optax
    from icon_tpu.config import Config
    from icon_tpu_torch.training.normal_step import make_normal_optimizer
    from icon_tpu_torch.utils.convert import _optax_leaves
    cfg = Config(lr_N=1e-2, lr_G=5.0, schedule=(1,), gamma=0.1,
                 optim="RMSprop", momentum=0.9, weight_decay=1e-3)
    rng = np.random.RandomState(0)
    net = torch.nn.Linear(4, 5)
    tx = optax.adam(optax.piecewise_constant_schedule(1e-2, {2: 0.1}))
    jp = {k: jnp.asarray(v.detach().numpy())
          for k, v in net.named_parameters()}
    js = tx.init(jp)
    opt = make_normal_optimizer(net, port_cfg(cfg), steps_per_epoch=2)
    assert opt.kind == "adam"
    for step in range(3):
        g = {k: (rng.randn(*v.shape) * 10.0 ** -step).astype(np.float32)
             for k, v in jp.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in net.named_parameters():
            p.grad = t(g[k])
        opt.step()
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert opt.lr() == pytest.approx(1e-3) and opt.count == 3
    found = {}
    _optax_leaves(jax.device_get(js), found)
    for k in ("mu", "nu"):
        for pk in jp:
            np.testing.assert_allclose(opt.state[pk][k].numpy(),
                                       np.asarray(found[k][pk]),
                                       rtol=1e-6, atol=1e-12)


def _batch(rng, n=2, size=64):
    """Seeded NHWC inputs and unit-normal targets, the image empty on a
    border so that the foreground mask is not all ones."""
    b = {k: rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
         for k in KEYS}
    for k in ("normal_F", "normal_B"):
        b[k] /= np.linalg.norm(b[k], axis=-1, keepdims=True)
    b["image"][:, :8] = 0.0
    return b


def _gauge(name: str, n_down: int, n_blocks: int) -> bool:
    """A conv bias that feeds an affine-free InstanceNorm (every bias but
    the output conv's)."""
    return name.endswith(".bias") and \
        f"model.{5 + 6 * n_down + n_blocks}." not in name


def test_three_adam_steps_match(vgg_path):
    from icon_tpu.models.normalnet import NormalNet as JNet
    from icon_tpu.training.normal_step import (create_normal_state,
                                               normal_eval_step as jeval,
                                               normal_train_step as jstep)
    from icon_tpu_torch.models.normalnet import NormalNet
    from icon_tpu_torch.models.vgg import load_vgg19
    from icon_tpu_torch.training.normal_step import (make_normal_optimizer,
                                                     normal_eval_step,
                                                     normal_train_step)
    from icon_tpu_torch.utils.convert import normal_state_from_flax
    from icon_tpu_torch.config import Config
    kw = dict(ngf=8, n_downsampling=2, n_blocks=1)
    rng = np.random.RandomState(2)
    batches = [_batch(rng) for _ in range(3)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    state = create_normal_state(JNet(**kw), jax.random.PRNGKey(0), jb[0],
                                lr=LR, schedule=(1,), gamma=0.1,
                                steps_per_epoch=2)
    net = NormalNet(**kw)
    opt = make_normal_optimizer(net, Config(lr_N=LR, schedule=(1,),
                                            gamma=0.1), steps_per_epoch=2)
    sd = normal_state_from_flax(*jax.device_get((state.params,
                                                 state.opt_state)), opt)
    net.load_state_dict({k: t(np.ascontiguousarray(v))
                         for k, v in sd.items()})
    for i, (a, b) in enumerate(zip(jb, batches)):
        state, jm = jstep(state, a)
        m = normal_train_step(net, opt, {k: t(v) for k, v in b.items()})
        rtol = 1e-5 if i == 0 else 1e-4
        for k in ("loss", "loss_F", "loss_B"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=rtol), k
    assert opt.count == opt.adam_count == 3
    want = normal_state_from_flax(jax.device_get(state.params))
    got = net.state_dict()
    bound = 2 * 3 * LR * 1.01
    for k, v in want.items():
        d = np.abs(got[k].numpy() - v)
        assert d.max() <= bound, (k, d.max())
        if not _gauge(k, 2, 1):
            assert np.median(d) <= PARAM_MEDIAN, (k, np.median(d))
    vgg = load_vgg19(vgg_path)
    jv = _jax_vgg(vgg_path)
    for v, jvv in ((None, None), (vgg, jv)):
        m = normal_eval_step(net, {k: t(x) for k, x in batches[0].items()},
                             v)
        jm = jeval(state, jb[0], vgg=jvv)
        for k in ("loss", "loss_F", "loss_B"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    assert float(m["loss"]) > float(m["loss_F"] + m["loss_B"])


def _children():
    me = str(os.getpid())
    out = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as fh:
                    fields = fh.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if fields[1] == me and fields[0] != "Z":
                out.append(int(name))
    return out


def _write_cfg(root, tmp_path, **over):
    from icon_tpu_torch.config import save_config
    cfg = port_cfg(_cfg(root)).replace(
        ckpt_dir=str(tmp_path / "ckpt"), num_threads=2, num_epoch=4,
        lr_N=LR, **over)
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)
    return path


def test_train_normal_cli(fixture_root, vgg_path, tmp_path, capsys):
    """Four epochs of two steps with two loader workers, validation with
    the VGG term each epoch, the top 3 checkpoints by val loss plus the
    latest kept, a panel each step; ``-resume`` continues the step count;
    no child process is left."""
    from icon_tpu_torch.apps.train_normal import main
    path = _write_cfg(fixture_root, tmp_path)
    rec = main(["-cfg", path, "--max_steps", "8", "--vgg_ckpt", vgg_path],
               device="cpu")
    assert rec["steps"] == 8 and rec["vgg"]
    assert np.isfinite(rec["losses"]).all() and len(rec["losses"]) == 8
    assert len(rec["val_loss"]) == 4 and np.isfinite(rec["val_loss"]).all()
    kept = sorted(p for p in os.listdir(tmp_path / "ckpt" / "fixture-icon")
                  if p.endswith(".pt"))
    best3 = sorted(rec["ckpts"][i] for i in np.argsort(rec["val_loss"])[:3])
    assert kept == sorted({osp.basename(p) for p in best3}
                          | {osp.basename(rec["ckpts"][-1])})
    assert len(rec["panels"]) == 8 and all(osp.getsize(p) > 0
                                           for p in rec["panels"])
    assert osp.exists(tmp_path / "ckpt" / "fixture-icon" / "cfg.yaml")
    assert multiprocessing.active_children() == [] and _children() == []
    rec = main(["-cfg", path, "-resume", "--max_steps", "9", "num_epoch",
                "5"], device="cpu")
    assert (rec["start_step"], rec["steps"]) == (8, 9) and not rec["vgg"]
    out = capsys.readouterr().out
    assert "resumed step 8" in out and "no VGG19 weights" in out
    assert multiprocessing.active_children() == [] and _children() == []


def test_train_normal_cli_refuses_several_devices(fixture_root, tmp_path):
    from icon_tpu_torch.apps.train_normal import main
    path = _write_cfg(fixture_root, tmp_path)
    with pytest.raises(NotImplementedError, match="A10"):
        main(["-cfg", path, "num_devices", "2"], device="cpu")
