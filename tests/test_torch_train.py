"""Port parity, the geometry trainer: icon_tpu_torch's fixture writer,
dataset, loader, optimizer, train step, checkpoints and train CLI against
the JAX package, on the JAX package's fixture (2 subjects, 2 views, 32^2,
visibility at 128^2) written once for the module.

Tolerances:
- fixture: the calib files and visibility arrays identical, each PNG
  within one u8 step, the fits identical, the scans' vertices to 1e-5 (the
  body model's float32 sums in another order);
- items: the samples, labels, signs and ``smpl_query_inside`` identical;
  the images to one float32 step of the decoded value (2.4e-7); the body's
  vertices to 1e-6 (the same rounding of the body model);
- the optimizer on identical gradients: parameters and states to 1e-6
  relative (float32 in another order of operations);
- whole steps: ``tests/test_torch_train_steps.py``.
"""

import multiprocessing
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import port_cfg, t

SIZE, VIEWS = 32, 2


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from icon_tpu.data.fixture import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp("jax_fixture"))
    make_synthetic_dataset(root, n_subjects=2, n_views=VIEWS, size=SIZE,
                           vis_res=128)
    return root


def jax_cfg(root, prior="icon", **over):
    from icon_tpu.data.fixture import fixture_config
    cfg = fixture_config(root, n_views=VIEWS, prior_type=prior,
                         num_sample_geo=128, image_size=SIZE)
    return cfg.replace(**over)


def test_fixture_files_match(fixture_root, tmp_path):
    """The port's fixture writer (on the CPU) against the JAX package's."""
    import pickle
    from PIL import Image
    from icon_tpu_torch.data.fixture import make_synthetic_dataset
    from icon_tpu_torch.utils.io import load_obj
    mine = str(tmp_path / "port")
    make_synthetic_dataset(mine, n_subjects=2, n_views=VIEWS, size=SIZE,
                           vis_res=128, device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), mine)
                   for d, _, fs in os.walk(mine) for f in fs)
    ref_files = sorted(os.path.relpath(os.path.join(d, f), fixture_root)
                       for d, _, fs in os.walk(fixture_root) for f in fs)
    assert files == ref_files and len(files) == 2 * (2 + VIEWS * 7) + 3
    for rel in files:
        a, b = os.path.join(mine, rel), os.path.join(fixture_root, rel)
        if rel.endswith(".png"):
            pa = np.asarray(Image.open(a), np.int32)
            pb = np.asarray(Image.open(b), np.int32)
            assert np.abs(pa - pb).max() <= 1, rel
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), rel)
        elif rel.endswith(".obj"):
            (va, fa), (vb, fb) = load_obj(a), load_obj(b)
            np.testing.assert_array_equal(fa, fb)
            np.testing.assert_allclose(va, vb, rtol=0, atol=1e-5)
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fh, open(b, "rb") as gh:
                pa, pb = pickle.load(fh), pickle.load(gh)
            assert set(pa) == set(pb)
            for k in pa:
                np.testing.assert_array_equal(pa[k], pb[k])
        else:
            with open(a) as fh, open(b) as gh:
                assert fh.read() == gh.read(), rel


@pytest.mark.parametrize("prior", ["icon", "pamir"])
def test_dataset_items_match(fixture_root, prior):
    from icon_tpu.data.datasets import PIFuDataset as JD
    from icon_tpu_torch.data.datasets import PIFuDataset as PD
    cfg = jax_cfg(fixture_root, prior)
    jd, pd = JD(cfg), PD(port_cfg(cfg))
    assert len(jd) == len(pd) == 4
    exact = ("sample", "label", "pts_signs", "smpl_query_inside",
             "smpl_faces", "smpl_vf_table", "smpl_vis", "smpl_cmap", "calib")
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        pd.set_epoch(epoch)
        for i in (0, 3):
            a, b = jd[i], pd[i]
            assert set(a) == set(b)
            for k in exact:
                np.testing.assert_array_equal(b[k], a[k], k)
            for k in ("image", "normal_F", "normal_B", "T_normal_F",
                      "T_normal_B"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2.4e-7)
            np.testing.assert_allclose(b["smpl_verts"], a["smpl_verts"],
                                       rtol=0, atol=1e-6)
            if prior == "pamir":
                for k in ("voxel_verts", "voxel_codes"):
                    np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6)
            assert (a["subject"], a["rotation"]) == (b["subject"],
                                                     b["rotation"])
    assert 0.3 <= b["label"].mean() <= 0.7
    pd.set_epoch(0)
    assert not np.array_equal(pd[0]["sample"], b["sample"])


def test_image_decode_matches(fixture_root):
    """The port's decode (PIL, ``(rgb * 2 - 1) * alpha``) against the JAX
    package's function on every rendered map."""
    from icon_tpu.data.datasets import _imagepath2tensor
    from icon_tpu_torch.data.datasets import imagepath2tensor
    folder = os.path.join(fixture_root, f"synth_{VIEWS}views", "0000")
    for name in ("render", "normal_F", "normal_B", "T_normal_F",
                 "T_normal_B"):
        path = os.path.join(folder, name, "000.png")
        got, want = imagepath2tensor(path), _imagepath2tensor(path)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
        assert (got[..., 0] == 0).mean() > 0.1         # the background


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


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match(fixture_root, workers):
    """The port's loader in the JAX loader's order, the same batches with
    and without worker processes, the workers gone after an early stop."""
    from icon_tpu.data.datasets import DataLoader, PIFuDataset as JD
    from icon_tpu_torch.data.datasets import (PIFuDataset, close_iter,
                                              make_loader)
    cfg = jax_cfg(fixture_root)
    jl = DataLoader(JD(cfg), batch_size=2, num_workers=1)
    loader = make_loader(PIFuDataset(port_cfg(cfg)), batch_size=2,
                         num_workers=workers)
    assert len(loader) == len(jl) == 2
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        loader.set_epoch(epoch)
        got = list(loader)
        for a, b in zip(jl, got):
            assert a["subject"] == b["subject"]
            assert a["rotation"] == b["rotation"]
            for k in ("sample", "label", "smpl_query_inside"):
                np.testing.assert_array_equal(b[k].numpy(), a[k])
            np.testing.assert_array_equal(b["smpl_faces"].numpy(),
                                          a["smpl_faces"])
    it = iter(loader)
    next(it)
    close_iter(it)
    assert not _children()


def _jax_state(cfg, batch, steps_per_epoch):
    from icon_tpu.models.hgpifu import HGPIFuNet
    from icon_tpu.training.train_step import create_train_state
    return create_train_state(HGPIFuNet(cfg), jax.random.PRNGKey(0), batch,
                              cfg, steps_per_epoch=steps_per_epoch)


def _port_from_jax(cfg, state, steps_per_epoch):
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.training.train_step import make_optimizer
    from icon_tpu_torch.utils.convert import train_state_from_flax
    pc = port_cfg(cfg)
    net = HGPIFuNet(pc, normal_net=False)
    opt = make_optimizer(net, pc, steps_per_epoch=steps_per_epoch)
    sd = train_state_from_flax(*jax.device_get(
        (state.params, state.batch_stats, state.opt_state)), opt)
    net.load_state_dict({k: t(np.ascontiguousarray(v)) for k, v in
                         sd.items()})
    return net, opt


OPTIMS = {"rmsprop": dict(optim="RMSprop"),
          "rmsprop-momentum": dict(optim="RMSprop", momentum=0.9),
          "adam": dict(optim="Adam"),
          "sgd-momentum": dict(optim="SGD", momentum=0.9)}


@pytest.mark.parametrize("name", list(OPTIMS))
def test_optimizer_matches_optax(name):
    """Three steps on identical gradients, across a schedule boundary (at
    step 2), with weight decay: the port's update rule is optax's."""
    from icon_tpu.config import Config
    from icon_tpu.training.train_step import make_optimizer as jmake
    from icon_tpu_torch.training.train_step import Optimizer
    cfg = Config(lr_G=1e-2, schedule=(1,), gamma=0.1, weight_decay=1e-3,
                 **OPTIMS[name])
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(5, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    tx = jmake(cfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v.copy())) for k, v in params.items()}
    opt = Optimizer(tp.items(), port_cfg(cfg), steps_per_epoch=2)
    for step in range(3):
        g = {k: (rng.randn(*v.shape) * 10.0 ** -step).astype(np.float32)
             for k, v in params.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert opt.lr() == pytest.approx(1e-3) and opt.count == 3
    from icon_tpu_torch.utils.convert import _optax_leaves
    found = {}
    _optax_leaves(jax.device_get(js), found)
    for k in ("nu", "mu", "trace"):
        if k in found:
            for pk in params:
                np.testing.assert_allclose(opt.state[pk][k].numpy(),
                                           np.asarray(found[k][pk]),
                                           rtol=1e-6, atol=1e-12)
    assert found["count"] == opt.count


def test_voxel_inputs_need_no_gradient(fixture_root, monkeypatch):
    """A pamir train step differentiates the parameters only: the loader's
    voxel vertices and codes reach the voxelization without a gradient, so
    the step runs the voxelization's forward alone and launches no backward
    kernel of it (here: never reaches its plain backward twins)."""
    from icon_tpu_torch.data.datasets import PIFuDataset, collate
    from icon_tpu_torch.kernels import voxelize as kv
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.ops import voxelize as pv
    from icon_tpu_torch.training.train_step import make_optimizer, train_step
    cfg = port_cfg(jax_cfg(fixture_root, "pamir"))
    seen, backward = [], []
    inner = kv.voxelize_semantic

    def spy(verts, codes, res):
        seen.append((verts.requires_grad, codes.requires_grad))
        return inner(verts, codes, res)
    monkeypatch.setattr(kv, "voxelize_semantic", spy)
    for name in ("box_smooth3d_bwd_plain", "voxel_splat_bwd_plain"):
        def spy_bwd(*a, _name=name, _inner=getattr(pv, name), **kw):
            backward.append(_name)
            return _inner(*a, **kw)
        monkeypatch.setattr(pv, name, spy_bwd)
    net = HGPIFuNet(cfg, normal_net=False)
    batch = collate([PIFuDataset(cfg)[i] for i in range(2)])
    before = (kv.launches_splat_bwd, kv.launches_smooth_bwd)
    m = train_step(net, make_optimizer(net, cfg), batch)
    assert np.isfinite(float(m["loss"]))
    assert seen == [(False, False)]
    assert backward == []
    assert (kv.launches_splat_bwd, kv.launches_smooth_bwd) == before
    assert net.ve.conv1.weight.grad is not None  # the encoder trains
    assert len(net.ve(torch.zeros(1, 3, 32, 32, 32),
                      intermediate_output=True)) == cfg.net.num_stack
    # the spies see a backward where the vertices do need a gradient
    verts = batch["voxel_verts"].clone().requires_grad_(True)
    inner(verts, batch["voxel_codes"], 8).sum().backward()
    assert backward == ["box_smooth3d_bwd_plain", "voxel_splat_bwd_plain"]


def test_checkpoints_resume_and_warm_start(fixture_root, tmp_path):
    from icon_tpu_torch.data.datasets import PIFuDataset, collate
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.training.checkpoints import (CheckpointManager,
                                                     load_checkpoint,
                                                     partial_warm_start,
                                                     restore)
    from icon_tpu_torch.training.train_step import make_optimizer, train_step
    cfg = port_cfg(jax_cfg(fixture_root, momentum=0.5))
    batch = collate([PIFuDataset(cfg)[i] for i in range(2)])
    torch.manual_seed(0)
    net = HGPIFuNet(cfg)
    opt = make_optimizer(net, cfg)
    mgr = CheckpointManager(str(tmp_path / "run"), top_k=2)
    paths = []
    for step, val in enumerate((0.5, 0.2, 0.9, 0.3), start=1):
        train_step(net, opt, batch)
        paths.append(mgr.save(step, net, opt, val))
    kept = sorted(os.listdir(tmp_path / "run"))
    assert kept == ["ckpt_2.pt", "ckpt_4.pt", "index.json"]
    assert mgr.best == paths[1] and mgr.latest == paths[3]
    saved = load_checkpoint(paths[3])["state_dict"]
    assert not any(k.startswith("normal_filter") for k in saved)
    # a new run resumes the latest: parameters, statistics, optimizer, step
    torch.manual_seed(1)
    net2 = HGPIFuNet(cfg)
    opt2 = make_optimizer(net2, cfg)
    assert restore(net2, opt2, CheckpointManager(
        str(tmp_path / "run")).latest) == 4
    for k, v in net.state_dict().items():       # the NormalNet ships apart
        if not k.startswith("normal_filter."):
            np.testing.assert_array_equal(net2.state_dict()[k].numpy(),
                                          v.numpy(), k)
    assert opt2.count == opt.count == 4
    for k, st in opt.state.items():
        for kind, v in st.items():
            np.testing.assert_array_equal(opt2.state[k][kind].numpy(),
                                          v.numpy())
    a = float(train_step(net, opt, batch)["loss"])
    b = float(train_step(net2, opt2, batch)["loss"])
    assert a == b
    # the normal network's checkpoint warm-starts under normal_filter
    normal = {"netG." + k[len("normal_filter."):]: v + 1.0 for k, v in
              net.state_dict().items() if k.startswith("normal_filter.")}
    normal["netG.unknown"] = torch.zeros(3)
    merged = partial_warm_start(net.state_dict(), normal,
                                rename={"netG": "normal_filter"})
    k = next(k for k in merged if k.startswith("normal_filter."))
    np.testing.assert_array_equal(merged[k].numpy(),
                                  net.state_dict()[k].numpy() + 1.0)
    assert "normal_filter.unknown" not in merged


def _write_cfg(cfg, path):
    from icon_tpu_torch.config import save_config
    save_config(cfg, str(path))
    return str(path)


def test_train_cli_leaves_no_child(fixture_root, tmp_path, capsys):
    """The train CLI in this process with 2 loader workers: it trains, its
    step count continues on ``-resume``, and no child process is left."""
    from icon_tpu_torch.apps.train import main
    cfg = port_cfg(jax_cfg(fixture_root)).replace(
        ckpt_dir=str(tmp_path / "ckpt"), num_threads=2, num_epoch=3)
    path = _write_cfg(cfg, tmp_path / "cfg.yaml")
    rec = main(["-cfg", path, "--max_steps", "2"], device="cpu")
    assert rec["steps"] == 2 and np.isfinite(rec["losses"]).all()
    assert len(rec["panels"]) == 2 and all(os.path.getsize(p) > 0
                                           for p in rec["panels"])
    assert multiprocessing.active_children() == []
    assert _children() == []
    rec = main(["-cfg", path, "-resume", "--max_steps", "3"], device="cpu")
    assert (rec["start_step"], rec["steps"]) == (2, 3)
    assert "resumed from" in capsys.readouterr().out
    assert multiprocessing.active_children() == []
    assert _children() == []


@pytest.mark.parametrize("argv,what", [(["-dist"], "A10"),
                                       (["num_devices", "2"], "A10")])
def test_train_cli_refuses_several_devices(fixture_root, tmp_path,
                                           monkeypatch, argv, what):
    """The options of ROADMAP item ``what``, which the CLI refused before
    that item was ported, run. ``-dist`` without an environment is the
    plain single-process run, bit for bit. ``num_devices 2`` on the CPU
    trains 2 gloo ranks (2 loader workers each), each on its half of every
    batch, and equals the 1-device run: 3 SGD steps over 2 epochs, the
    losses to 1e-5 relative (1e-4 after the first), the validation losses
    to 1e-5, and the last checkpoint's parameters and BatchNorm statistics
    to atol 1e-5, rtol 1e-4 (tests/test_dist.py:218's bound); rank 0
    alone writes the checkpoints; no child is left."""
    from icon_tpu_torch.apps.train import main
    from icon_tpu_torch.training.checkpoints import load_checkpoint
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    recs = []
    for run, extra in (("plain", []), ("option", argv)):
        cfg = port_cfg(jax_cfg(fixture_root)).replace(
            ckpt_dir=str(tmp_path / run), num_threads=2, num_epoch=2,
            optim="SGD")
        path = _write_cfg(cfg, tmp_path / f"{run}.yaml")
        recs.append(main(["-cfg", path, "--max_steps", "3"] + extra,
                         device="cpu", timeout=120))
        assert multiprocessing.active_children() == []
        assert _children() == []
    plain, option = recs
    assert (plain["ranks"], option["ranks"]) == (1, 1 if argv == ["-dist"]
                                                 else 2)
    assert plain["steps"] == option["steps"] == 3
    if argv == ["-dist"]:
        assert option["losses"] == plain["losses"]
    np.testing.assert_allclose(option["losses"][0], plain["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(option["losses"], plain["losses"], rtol=1e-4)
    np.testing.assert_allclose(option["val_loss"], plain["val_loss"],
                               rtol=1e-5)
    assert [os.path.basename(p) for p in option["ckpts"]] == \
        [os.path.basename(p) for p in plain["ckpts"]]
    want = load_checkpoint(plain["ckpts"][-1])["state_dict"]
    got = load_checkpoint(option["ckpts"][-1])["state_dict"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
