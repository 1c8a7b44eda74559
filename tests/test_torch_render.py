"""Port parity, the dataset renderer: ``vertex_visibility_depth``,
``compute_prt``, ``render_subject_views`` with PRT and the render CLI
(``apps/render.py``) of icon_tpu_torch against the JAX package's, on the
CPU.

Tolerances:

- visibility, on the two-sphere snowman of ``tests/test_prt.py`` from 16
  Fibonacci directions at 128^2 and 256^2: each vertex's value to 1e-5
  (the bilinear weights round differently), except that a depth at the
  ``eps`` edge may flip one of a vertex's four PCF terms, so up to
  ``PCF_FLIPS`` vertices a direction may differ by up to 1 (a whole
  texel's weight);
- the PRT transport to 1e-5 max-abs (of ~0.33): the snowman has no such
  flip at these sizes, so ``T`` differs by float32 rounding alone;
- rendered files: masks (the PNGs' alpha) identical, the visibility
  ``.npy`` identical, and the RGB bytes within one step on at most
  ``U8_SHARE`` of the values: an attribute that differs by an ulp can
  cross a step of the ``(rgba * 255).astype(uint8)`` truncation.
"""

import os
import os.path as osp
import pickle
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_prt import _snowman

PCF_FLIPS = 2
VIS_ATOL = 1e-5
PRT_ATOL = 1e-5
U8_SHARE = 1e-3
N_DIRS = 16


def _frame(d):
    """compute_prt's per-direction world -> view rotation."""
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(np.dot(up, d)) > 0.95:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    x = np.cross(up, d)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(d, x), d]).astype(np.float32)


@pytest.mark.parametrize("res", [128, 256])
def test_vertex_visibility_depth_matches(res):
    from icon_tpu.data.render_dataset import fibonacci_sphere
    from icon_tpu.ops.raster import vertex_visibility_depth as jvis
    from icon_tpu_torch.ops.raster import vertex_visibility_depth
    v, f = _snowman()
    flip = np.array([1, -1, -1], np.float32)
    for d in fibonacci_sphere(N_DIRS):
        ndc = (v @ _frame(d).T) * flip
        want = np.asarray(jvis(jnp.asarray(ndc), jnp.asarray(f), res=res))
        got = vertex_visibility_depth(torch.from_numpy(ndc),
                                      torch.from_numpy(f).long(),
                                      res=res).numpy()
        assert got.shape == (len(v),) and got.dtype == np.float32
        diff = np.abs(got - want)
        assert (diff > VIS_ATOL).sum() <= PCF_FLIPS and diff.max() <= 1.0
        assert 0.2 < want.mean() < 0.8          # both sides seen


def test_compute_prt_matches():
    from icon_tpu.data.render_dataset import compute_prt as jprt
    from icon_tpu_torch.data.render_dataset import compute_prt
    v, f = _snowman()
    want = np.asarray(jprt(v, f, n_dirs=N_DIRS, vis_res=128))
    got = compute_prt(v, f, n_dirs=N_DIRS, vis_res=128, device="cpu")
    assert got.shape == (len(v), 9) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PRT_ATOL)


def _compare_trees(mine: str, ref: str) -> list:
    """Every file of ``ref`` against ``mine`` at the module's tolerances;
    returns the relative paths."""
    from PIL import Image
    files = sorted(osp.relpath(osp.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    assert files == sorted(osp.relpath(osp.join(d, f), mine)
                           for d, _, fs in os.walk(mine) for f in fs)
    for rel in files:
        a, b = osp.join(mine, rel), osp.join(ref, rel)
        if rel.endswith(".png"):
            pa = np.asarray(Image.open(a), np.int32)
            pb = np.asarray(Image.open(b), np.int32)
            np.testing.assert_array_equal(pa[..., 3], pb[..., 3], rel)
            d = np.abs(pa - pb)
            assert d.max() <= 1 and (d > 0).mean() <= U8_SHARE, rel
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), rel)
        else:
            np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b),
                                       rtol=0, atol=0, err_msg=rel)
    return files


def test_render_subject_views_prt_matches(tmp_path):
    """The snowman as the scan, lit by its PRT transport, and the
    synthetic body, at 64^2 from three azimuths, against the JAX
    function's files."""
    from icon_tpu.data.render_dataset import compute_prt as jprt
    from icon_tpu.data.render_dataset import render_subject_views as jrender
    from icon_tpu_torch.data.render_dataset import render_subject_views
    from icon_tpu_torch.utils.synthetic import synthetic_body
    v, f = _snowman()
    bv, bf = synthetic_body(subdiv=2)
    prt = np.asarray(jprt(v, f, n_dirs=N_DIRS, vis_res=128))
    kw = dict(rotations=(0, 120, 240), size=64, seed=3, prt=prt,
              vis_res=128)
    jrender(str(tmp_path / "jax"), v, f, bv, bf, **kw)
    render_subject_views(str(tmp_path / "port"), v, f, bv, bf,
                         device="cpu", **kw)
    files = _compare_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(files) == 3 * 7


def _descendants() -> set:
    """This process's live descendants, from /proc."""
    children, state = {}, {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as fh:
                    fields = fh.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            state[int(name)] = fields[0]
            children.setdefault(int(fields[1]), []).append(int(name))
    out, todo = set(), list(children.get(os.getpid(), []))
    while todo:
        p = todo.pop()
        todo += children.get(p, [])
        if state.get(p) != "Z":
            out.add(p)
    return out


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two subjects' scans and fits (the port's fixture writer; its files
    equal the JAX package's, tests/test_torch_train.py)."""
    from icon_tpu_torch.data.fixture import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp("render_cli"))
    make_synthetic_dataset(root, n_subjects=2, n_views=1, size=16,
                           vis_res=32, device="cpu")
    return root


def _copy_inputs(src: str, dst: str) -> str:
    import shutil
    shutil.copytree(osp.join(src, "synth"), osp.join(dst, "synth"))
    return dst


CLI = ["-dataset", "synth", "-views", "2", "-size", "32", "-prt",
       "-prt_dirs", "2", "-vis_res", "64"]


def test_render_cli_matches(scans, tmp_path, monkeypatch):
    """The CLI with ``-procs 1`` and ``-procs 2`` against the JAX CLI's
    files; no worker left after the pool run."""
    from icon_tpu.apps import render as jrender
    from icon_tpu_torch.apps.render import main
    ref = _copy_inputs(scans, str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["render", "-root", ref, "-procs", "1"]
                        + CLI)
    jrender.main()
    for procs in ("1", "2"):
        mine = _copy_inputs(scans, str(tmp_path / f"port{procs}"))
        before = _descendants()
        recs = main(["-root", mine, "-procs", procs] + CLI, device="cpu")
        assert _descendants() <= before
        assert [(r["subject"], r["status"], r["body"], r["views"])
                for r in recs] == [("0000", "rendered", True, 2),
                                   ("0001", "rendered", True, 2)]
        files = _compare_trees(osp.join(mine, "synth_2views"),
                               osp.join(ref, "synth_2views"))
        assert len(files) == 2 * 2 * 7


def test_render_cli_fit_errors(scans, tmp_path):
    """A subject without a fit renders without its body, as in the JAX
    CLI; a fit that does not pose raises, in this process and from a
    pool's worker (the pool closed), and writes no render without the
    body."""
    from icon_tpu_torch.apps.render import main
    root = _copy_inputs(scans, str(tmp_path))
    os.remove(osp.join(root, "synth", "fits", "0000", "smplx_param.pkl"))
    recs = main(["-root", root, "-procs", "1", "-subjects", "0000"] + CLI,
                device="cpu")
    assert recs[0]["status"] == "rendered" and not recs[0]["body"]
    out = osp.join(root, "synth_2views")
    assert sorted(os.listdir(osp.join(out, "0000"))) == [
        "calib", "normal_B", "normal_F", "render"]
    fit = osp.join(root, "synth", "fits", "0001", "smplx_param.pkl")
    with open(fit, "rb") as fh:
        param = pickle.load(fh)
    del param["betas"]
    with open(fit, "wb") as fh:
        pickle.dump(param, fh)
    with pytest.raises(KeyError):
        main(["-root", root, "-procs", "1", "-subjects", "0001"] + CLI,
             device="cpu")
    assert not osp.exists(osp.join(out, "0001"))
    before = _descendants()
    with pytest.raises(KeyError):          # raised in a worker of the pool
        main(["-root", root, "-procs", "2"] + CLI, device="cpu")
    assert _descendants() <= before
    assert not osp.exists(osp.join(out, "0001"))
