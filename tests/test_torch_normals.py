"""Vertex normals summed in a fixed order, and the renderer's bytes.

``ops/mesh.py:vertex_normals`` sums each vertex's face normals; CUDA's
``index_add_`` adds with atomics in no fixed order, so on the card the same
mesh gave normals a last bit apart from run to run, and the dataset
renderer's ``-procs 1`` and ``-procs 2`` runs wrote PNGs that differed.
Every tensor now takes ``ordered_vertex_sum``, which adds in the order that
``index_add_`` keeps on the CPU. Held here: that order, bit for bit, at 1
and at 4 intra-op threads (so the CPU's normals keep their bits); its
gradient; the render CLI's bytes at
``-procs 1`` under 1 and 4 threads and at ``-procs 2`` (workers at 1
thread); and, on the card, the same normals on every run. Imports no JAX.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from icon_tpu_torch.ops.mesh import (face_normals, ordered_vertex_sum,
                                     vertex_normals)


def _mesh(V: int, F: int, seed: int, B: int = 1):
    """Random faces over few vertices (about 3F/V terms a vertex)."""
    rng = np.random.RandomState(seed)
    f = torch.as_tensor(rng.randint(0, V, (F, 3)))
    v = torch.as_tensor(rng.normal(size=(B, V, 3)).astype(np.float32))
    return v, f


def _index_add_sum(values, faces, n_verts):
    out = values.new_zeros((values.shape[0], n_verts, values.shape[2]))
    for j in range(3):
        out.index_add_(1, faces[:, j], values)
    return out


@pytest.mark.parametrize("V,F,B", [(50, 3000, 1), (2000, 12000, 2),
                                   (10, 0, 1), (100, 20, 1)])
def test_ordered_vertex_sum_is_index_add_order(V, F, B):
    v, f = _mesh(V, F, V + F, B)
    fn = face_normals(v, f, normalize=False)
    want = _index_add_sum(fn, f, V)
    threads = torch.get_num_threads()
    try:
        for t in (1, 4):
            torch.set_num_threads(t)
            for faces in (f, f.int()):
                got = ordered_vertex_sum(fn, faces, V)
                assert got.shape == (B, V, 3) and got.is_contiguous()
                assert torch.equal(got, want)
    finally:
        torch.set_num_threads(threads)


def test_ordered_vertex_sum_gradient():
    v, f = _mesh(12, 60, 3)
    vals = torch.randn(1, 60, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: ordered_vertex_sum(x, f, 12), (vals,))
    a = v.clone().requires_grad_()
    b = v.clone().requires_grad_()
    fn_a = face_normals(a, f, normalize=False)
    fn_b = face_normals(b, f, normalize=False)
    ordered_vertex_sum(fn_a, f, 12).square().sum().backward()
    _index_add_sum(fn_b, f, 12).square().sum().backward()
    # float32 gradients of ~6 whose backward adds the three corner slots'
    # terms in another order
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def _render(root, procs, threads):
    from icon_tpu_torch.apps.render import main
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return main(["-root", root, "-dataset", "synth", "-views", "2",
                     "-size", "32", "-prt", "-prt_dirs", "2", "-vis_res",
                     "64", "-procs", str(procs)], device="cpu")
    finally:
        torch.set_num_threads(before)


def _tree(recs) -> dict:
    out = {}
    for r in recs:
        for dp, _, fs in os.walk(r["out_dir"]):
            for name in fs:
                path = osp.join(dp, name)
                with open(path, "rb") as fh:
                    out[osp.relpath(path, osp.dirname(r["out_dir"]))] = \
                        fh.read()
    return out


def test_render_bytes_do_not_depend_on_procs_or_threads(tmp_path):
    """Two subjects through the render CLI on the CPU: ``-procs 1`` at 4
    and at 1 intra-op threads, and ``-procs 2`` (its workers at 1 thread),
    write the same bytes."""
    from icon_tpu_torch.data.fixture import make_synthetic_dataset
    src = str(tmp_path / "src")
    make_synthetic_dataset(src, n_subjects=2, n_views=1, size=16,
                           vis_res=32, device="cpu")
    trees = []
    for name, procs, threads in (("a", 1, 4), ("b", 1, 1), ("c", 2, 4)):
        root = str(tmp_path / name)
        os.makedirs(osp.join(root, "synth"))
        for sub in ("scans", "fits"):
            os.symlink(osp.join(src, "synth", sub),
                       osp.join(root, "synth", sub))
        trees.append(_tree(_render(root, procs, threads)))
    assert len(trees[0]) == 2 * 2 * 7
    assert trees[1] == trees[0] and trees[2] == trees[0]


@pytest.mark.cuda
def test_vertex_normals_repeat_on_the_card():
    """On the card, five runs give the same normals, and the sums equal the
    CPU's ``index_add_`` of the card's own face normals bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    v, f = _mesh(50, 3000, 7, B=2)
    v, f = v.to(dev), f.to(dev)
    runs = [vertex_normals(v, f) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    fn = face_normals(v, f, normalize=False)
    assert torch.equal(ordered_vertex_sum(fn, f, 50).cpu(),
                       _index_add_sum(fn.cpu(), f.cpu(), 50))
