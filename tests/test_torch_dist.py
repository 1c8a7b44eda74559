"""Port parity, multi-device: icon_tpu_torch.parallel against
icon_tpu.parallel (tests/test_dist.py's cases).

- ``distributed_env`` and ``initialize_distributed`` give the JAX
  functions' results on the same dicts; two ranks of an NCCL group on one
  card raise before the group exists;
- the loader's per-process slices equal the JAX ``DataLoader``'s, and a
  ragged final batch raises;
- ``shard_query`` over 8 CPU shards equals the unsharded engine bit for bit
  on a polynomial field, and the JAX ``shard_query`` on the 8-device
  virtual CPU mesh to 1e-5 for the tiny HGPIFuNet of tests/test_dist.py;
- BatchNorm's global moments under 2 gloo ranks equal numpy's to 1e-5
  (running mean and biased variance, for 1d, 2d and 3d), the outputs and
  gradients the one-process module's to 1e-5 of their largest;
- the NormalNet's Adam step (instance norm: only the gradients are
  reduced) under 2 gloo ranks, each on half of a global batch of 4 seeded
  32^2 items, against one process on the whole: 2 steps, the losses to
  1e-5 relative, the parameters to tests/test_dist.py:218's atol 1e-5,
  rtol 1e-4, but for the biases that feed an instance norm (a gradient at
  rounding level): Adam's largest move a step.

The ranks are spawned processes joined with a timeout of their own, so a
hang fails instead of stalling the suite; no child is left after them.
"""

import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_dist_ranks import (RANK_TIMEOUT, Ranks, bn_moments, children,
                              hang, normal_steps)
from torch_port_helpers import normalnet_cfg, port_cfg, port_state, t


# ---------------------------------------------------------------------------
# parallel/dist.py


@pytest.mark.parametrize("env", [
    {}, {"COORDINATOR_ADDRESS": "10.0.0.2:8476", "NUM_PROCESSES": "4",
         "PROCESS_ID": "2"},
    {"NUM_PROCESSES": "3"}, {"COORDINATOR_ADDRESS": "h:1"}])
def test_env_parsing_matches(env):
    from icon_tpu.parallel.dist import distributed_env as jenv
    from icon_tpu_torch.parallel.dist import distributed_env
    assert distributed_env(env) == jenv(env)


def test_single_process_is_noop():
    """The JAX function's False cases, and no group is made."""
    from icon_tpu.parallel import dist as J
    from icon_tpu_torch.parallel import dist as P
    for kw in ({"environ": {}}, {"num_processes": 1},
               {"environ": {"NUM_PROCESSES": "1"}}):
        assert P.initialize_distributed(**kw) is J.initialize_distributed(
            **kw) is False
    assert not torch.distributed.is_initialized()
    assert P.world() == 1 and P.rank() == 0
    assert P.is_main_process() and J.is_main_process()
    with pytest.raises(ValueError, match="coordinator"):
        P.initialize_distributed(num_processes=2, process_id=0,
                                 device="cpu")
    with pytest.raises(ValueError, match="NCCL needs a card"):
        P.initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl",
                                 device="cpu")


def test_two_ranks_on_one_card_need_gloo():
    """Two ranks of an NCCL group placed on cuda:0 both raise, naming
    gloo, before any group exists (the placement check needs no card)."""
    from icon_tpu_torch.parallel import dist
    port = dist.free_port()
    stores = [None, None]
    errors = [None, None]

    def rank(r):
        try:
            stores[r] = torch.distributed.TCPStore(
                "127.0.0.1", port, 2, is_master=r == 0,
                timeout=dist.TIMEOUT)
            dist._check_placement(stores[r], r, 2, torch.device("cuda", 0))
        except Exception as e:          # noqa: BLE001 - asserted below
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(RANK_TIMEOUT)
    assert not any(th.is_alive() for th in threads)
    for e in errors:
        assert isinstance(e, ValueError) and "gloo" in str(e), e
    assert not torch.distributed.is_initialized()


def test_hung_ranks_fail_and_leave_no_child():
    """Ranks that outlive the timeout raise TimeoutError; they are
    terminated, joined, and no child is left."""
    import time
    from icon_tpu_torch.parallel import dist
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        dist.run_on_mesh(hang, [torch.device("cpu")] * 2, timeout=3.0)
    assert time.monotonic() - t0 < 3.0 + dist.GRACE_S + 10.0
    assert children() == []


# ---------------------------------------------------------------------------
# the loader's per-process slices


class _Toy(torch.utils.data.Dataset):
    def __init__(self, n=30):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


def test_loader_process_slices_match():
    """As tests/test_dist.py:53: each process's batches are its contiguous
    slice of the global batch, the JAX loader's, for every process; the
    validation loader's padded last batch splits too; a ragged final batch
    raises."""
    from icon_tpu.data.datasets import DataLoader
    from icon_tpu_torch.data.datasets import make_loader

    def jax_batches(pi, pc, **kw):
        ld = DataLoader(_Toy(), batch_size=8, num_workers=1, seed=7,
                        process_index=pi, process_count=pc, **kw)
        ld.set_epoch(3)
        return [b["x"][:, 0].astype(int).tolist() for b in ld]

    def port_batches(pi, pc, **kw):
        ld = make_loader(_Toy(), batch_size=8, num_workers=0, seed=7,
                         process_index=pi, process_count=pc, **kw)
        ld.set_epoch(3)
        return [b["x"][:, 0].long().tolist() for b in ld]

    for kw in ({}, {"shuffle": False, "drop_last": False, "pad_last": True}):
        whole = port_batches(0, 1, **kw)
        assert whole == jax_batches(0, 1, **kw)
        for pc in (2, 4):
            parts = [port_batches(pi, pc, **kw) for pi in range(pc)]
            assert parts == [jax_batches(pi, pc, **kw) for pi in range(pc)]
            for bi, gb in enumerate(whole):
                assert sum((p[bi] for p in parts), []) == gb
    with pytest.raises(ValueError, match="cannot split"):
        port_batches(0, 2, drop_last=False)
    with pytest.raises(ValueError, match="not divisible"):
        make_loader(_Toy(), batch_size=6, process_index=0, process_count=4)


# ---------------------------------------------------------------------------
# point-sharded recon


def _poly(pts):
    q = (pts[..., 0] ** 2 * 1.0 + pts[..., 1] ** 2 * 1.3 +
         pts[..., 2] ** 2 * 0.8)
    return torch.clamp(0.5 + (0.3 - q) * 4.0, 0.0, 1.0)[..., None]


def test_shard_query_bitwise_analytic():
    """As tests/test_dist.py:134: the sharded engine (8 CPU shards, budgets
    and level 0 padded to 8) equals the unsharded one bit for bit on a
    polynomial field, level counts included; a point count that does not
    divide raises."""
    from icon_tpu_torch.parallel.mesh import make_mesh, shard_query
    from icon_tpu_torch.recon.engine import ReconEngine
    res = (17, 33, 65)
    occ_u, stats_u = ReconEngine(res, pad_multiple=8, device="cpu")(_poly)
    mesh = make_mesh(8, "cpu")
    occ_s, stats_s = ReconEngine(res, pad_multiple=8, device="cpu")(
        shard_query(_poly, mesh))
    assert torch.equal(occ_u, occ_s)
    for k in stats_u:
        assert torch.equal(stats_u[k], stats_s[k]), k
    with pytest.raises(AssertionError, match="not divisible"):
        shard_query(_poly, mesh)(torch.zeros(1, 12, 3))


def test_shard_query_matches_jax_net():
    """As tests/test_dist.py:170: the tiny HGPIFuNet's query, signed by ray
    bins, over 8 CPU shards of the port at levels (17, 33) with
    ``pad_multiple`` 8, against the JAX package's ``shard_query`` on its
    8-device mesh (jitted levels, as that test runs it) and against its
    unsharded engine with eager levels. Under one jit XLA picks other faces
    among those equidistant from a point than eager execution does (ROADMAP
    Queue C, "the body features jump"; the occupancy moves by up to 0.2
    there), and the port follows the eager picks: so the port's grid is
    held to the eager one to 1e-5 everywhere, and to the sharded jitted
    one to 1e-5 wherever that agrees with the eager one, which must be at
    least 80% of the grid."""
    from jax.sharding import Mesh
    from icon_tpu.ops.sdf_fast import build_ray_bins, build_vertex_face_table
    from icon_tpu.parallel.mesh import shard_query as jshard
    from icon_tpu.recon.engine import ReconEngine as JEngine
    from icon_tpu_torch.models.hgpifu import HGPIFuNet
    from icon_tpu_torch.parallel.mesh import (Replicas, make_mesh,
                                              shard_query)
    from icon_tpu_torch.recon.engine import ReconEngine
    from test_dist import _tiny_batch, _tiny_net

    jnet = _tiny_net()
    batch = _tiny_batch(B=1)
    variables = jax.jit(lambda k, b: jnet.init(k, b, train=False))(
        jax.random.PRNGKey(0), batch)
    in_keys = ("image", "normal_F", "normal_B")
    jfeat = jnet.apply(variables, {k: batch[k] for k in in_keys}, False,
                       method=jnet.filter)
    rb, rg = build_ray_bins(np.asarray(batch["smpl_verts"][0]),
                            np.asarray(batch["smpl_faces"]))
    table = build_vertex_face_table(np.asarray(batch["smpl_faces"]),
                                    batch["smpl_verts"].shape[1])
    jsmpl = {k: batch[k] for k in ("smpl_verts", "smpl_faces", "smpl_cmap",
                                   "smpl_vis")}
    jsmpl.update(smpl_vf_table=jnp.asarray(table),
                 smpl_ray_bins=jnp.asarray(rb), smpl_ray_grid=jnp.asarray(rg))

    def jquery(pts):
        return jnet.apply(variables, jfeat, pts, batch["calib"], jsmpl,
                          False, method=jnet.query)[-1]

    res = (17, 33)
    jmesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    with jmesh:
        jocc, _ = JEngine(res, pad_multiple=8)(jshard(jquery, jmesh),
                                               jit_levels=True)
        jocc = np.asarray(jax.device_get(jocc))
    eager = np.asarray(JEngine(res, pad_multiple=8)(jquery)[0])

    net = HGPIFuNet(port_cfg(jnet.cfg), normal_net=False)
    net.load_state_dict(port_state(variables))
    net.eval()
    net_on = Replicas(net)
    smpl = {k: t(v) for k, v in jsmpl.items()}
    for k in ("smpl_faces", "smpl_vf_table"):
        smpl[k] = smpl[k].long()
    with torch.no_grad():
        feats = net.filter({k: t(batch[k]) for k in in_keys})

        def query(pts, feats, calib, smpl):
            return net_on(pts.device).query(feats, pts, calib, smpl)[-1]

        occ, _ = ReconEngine(res, pad_multiple=8, device="cpu")(
            shard_query(query, make_mesh(8, "cpu")),
            query_args=(feats, t(batch["calib"]), smpl))
    occ = occ.numpy()
    np.testing.assert_allclose(occ, eager, rtol=0, atol=1e-5)
    same = np.abs(jocc - eager) <= 1e-5
    assert same.mean() >= 0.8
    np.testing.assert_allclose(occ[same], jocc[same], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# global BatchNorm moments under 2 gloo ranks


def test_global_bn_moments_two_ranks():
    """As tests/test_dist.py:271, for BatchNorm1d, 2d and 3d: under 2 gloo
    ranks each rank's running mean and (biased) variance are the global
    batch's, to 1e-5 of numpy's, and the same on both ranks; the ranks'
    outputs are the one-process module's on the global batch, and the
    averaged weight gradient is its gradient (the all-reduce backward), to
    1e-5 of their largest. The ranks' ``shard_batch`` slices put together
    give the global batch, the shared key whole on each; a gradient that
    is None on every rank stays None."""
    from icon_tpu_torch.models.layers import (BatchNorm1d, BatchNorm2d,
                                              BatchNorm3d)
    from icon_tpu_torch.parallel import dist
    rng = np.random.RandomState(3)
    xs = {1: rng.randn(8, 16, 4), 2: rng.randn(4, 6, 5, 3),
          3: rng.randn(6, 3, 4, 2, 3)}
    xs = {d: (x * 2.0 + 1.0).astype(np.float32) for d, x in xs.items()}
    ranks = dist.run_on_mesh(bn_moments, [torch.device("cpu")] * 2, (xs,),
                             timeout=RANK_TIMEOUT)
    assert children() == []
    for d, cls in ((1, BatchNorm1d), (2, BatchNorm2d), (3, BatchNorm3d)):
        x = xs[d]
        dims = (0,) + tuple(range(2, x.ndim))
        for r in ranks:
            np.testing.assert_allclose(r[d]["mean"], x.mean(dims),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r[d]["var"], x.var(dims),
                                       rtol=1e-5, atol=1e-5)
            assert r[d]["bytes"] == 4 * (2 * x.shape[1] + 2)
        np.testing.assert_array_equal(ranks[0][d]["var"], ranks[1][d]["var"])
        bn = cls(x.shape[1], momentum=1.0).train()
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt)
        (y * y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
        got = np.concatenate([r[d]["y"] for r in ranks])
        scale = float(y.detach().abs().max())
        np.testing.assert_allclose(got, y.detach().numpy(), rtol=0,
                                   atol=1e-5 * scale)
        # the ranks' losses sum to the global one, so the mean of their
        # gradients is half its gradient
        g = bn.weight.grad.numpy()
        for r in ranks:
            np.testing.assert_allclose(2.0 * r[d]["weight_grad"], g, rtol=0,
                                       atol=1e-5 * float(np.abs(g).max()))
    np.testing.assert_array_equal(
        np.concatenate([r["slice"]["x"] for r in ranks]), xs[2])
    assert [n for r in ranks for n in r["slice"]["names"]] == list("abcd")
    for r in ranks:
        np.testing.assert_array_equal(r["slice"]["smpl_faces"], np.arange(6))
        assert r["none_stays"]


def test_normal_step_two_ranks(tmp_path):
    import copy
    from icon_tpu_torch.apps.train_normal import build_normal_net
    from icon_tpu_torch.training.normal_step import (_losses,
                                                     make_normal_optimizer,
                                                     normal_train_step)
    cfg = port_cfg(normalnet_cfg())
    rng = np.random.RandomState(5)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)) for k in ("image", "T_normal_F", "T_normal_B",
                               "normal_F", "normal_B")}
    net = build_normal_net(cfg, "cpu")
    path = str(tmp_path / "normal.pt")
    torch.save({"cfg": cfg, "state": net.state_dict(), "batch": batch},
               path)
    ranks = Ranks(normal_steps, (path, 2))
    # the biases that feed an instance norm have a gradient of 0 but for
    # rounding, which Adam turns into whole steps of up to lr (1 - b1) /
    # sqrt(1 - b2) = 3.16 lr: those are held to that move, in either
    # direction, each step
    twin = copy.deepcopy(net).train()
    sum(_losses(twin, batch)[2:]).backward()
    grads = {k: float(p.grad.abs().max()) for k, p in
             twin.named_parameters()}
    top = max(grads.values())
    gauge = {k for k, g in grads.items() if g <= 1e-6 * top}
    assert gauge and all(k.endswith(".bias") for k in gauge)
    move = 1.01 * 2 * 2 * 3.17 * cfg.lr_N
    opt = make_normal_optimizer(net, cfg)
    one = [float(normal_train_step(net, opt, batch)["loss"])
           for _ in range(2)]
    want = {k: v.numpy() for k, v in net.state_dict().items()}
    for r in ranks.result():
        np.testing.assert_allclose(r["losses"], one, rtol=1e-5)
        for k, v in want.items():
            if k in gauge:
                assert np.abs(r["state"][k] - v).max() <= move, k
            else:
                np.testing.assert_allclose(r["state"][k], v, rtol=1e-4,
                                           atol=1e-5, err_msg=k)
