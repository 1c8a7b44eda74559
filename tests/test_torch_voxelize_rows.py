"""The voxelization backward at the rows the splat's backward reads, on the
CPU (no JAX): ``ops/voxelize.py:touched_rows`` lists the voxels of the
vertices' trilinear corners inside the volume as ``_corner_terms`` finds
them, and ``box_smooth3d_bwd_rows_plain``, the ``box_smooth3d_bwd``
kernel's twin (each row summed from its own window in the kernel's order),
equals the dense ``box_smooth3d_bwd_plain`` at those rows bit for bit
(``torch.equal``), for boxes k = 1, 2, 3, 4 and 11 (the window wider than
half the volume), rows on the volume's faces and corners, smoothed weights
on the 1e-3 tie and below it, two batch entries with shared and with
batched codes, with ties beside the rows as well. Then the backward
entry's CPU route and its refusals. The kernels themselves are held to
these twins on the card (``tests/test_torch_voxelize_cuda.py``)."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import voxelize as kv
from icon_tpu_torch.ops import voxelize as pv

RES = 14
B, V = 2, 48


def _verts(seed):
    """``[B, V, 3]`` vertices: the volume's 8 corners, 12 on its faces
    (one coordinate at -1 or 1), 6 partly or wholly outside it, one NaN,
    the rest inside."""
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-0.9, 0.9, (B, V, 3)).astype(np.float32)
    verts[:, :8] = [[x, y, z] for x in (-1, 1) for y in (-1, 1)
                    for z in (-1, 1)]
    for j in range(12):
        verts[:, 8 + j, j % 3] = (-1.0, 1.0)[j // 3 % 2]
    verts[:, 20:26] *= 1.6
    verts[1, 26] = np.nan
    return torch.from_numpy(verts)


def _smooth_inputs(k, batched, seed):
    """(g_out, out, weight, rows): the plain forward of ``_verts``' splat
    with shared or batched codes, a third of the touched rows' weights set
    to the 1e-3 tie and a third below it, and a seeded output gradient."""
    rng = np.random.RandomState(seed)
    verts = _verts(seed)
    codes = torch.from_numpy(rng.rand(*((B, V, 3) if batched else (V, 3)))
                             .astype(np.float32))
    acc = pv.voxel_splat_plain(verts, codes, RES)
    out, weight = pv.box_smooth3d_plain(acc.view(B, RES, RES, RES, 4), k,
                                        keep_weight=True)
    rows = pv.touched_rows(verts, RES)
    weight = weight.clone()
    weight.view(-1)[rows[::3]] = pv.WEIGHT_FLOOR
    weight.view(-1)[rows[1::3]] = 5e-4
    g_out = torch.from_numpy(rng.randn(B, RES, RES, RES, 3)
                             .astype(np.float32))
    return g_out, out, weight, rows


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 11])
def test_rows_twin_equals_the_dense_twin(k, batched):
    g_out, out, weight, rows = _smooth_inputs(k, batched, k + 20 * batched)
    zyx = np.stack(np.unravel_index(rows.numpy() % RES ** 3, (RES,) * 3), 1)
    assert {0, RES - 1} <= set(zyx.ravel())           # faces
    assert {0, RES ** 3 - 1} <= set(rows.numpy() % RES ** 3)   # corners
    assert {0, 1} == set(rows.numpy() // RES ** 3)    # both batch entries
    assert int((weight == pv.WEIGHT_FLOOR).sum()) >= len(rows) // 3
    got = pv.box_smooth3d_bwd_rows_plain(g_out, out, weight, k, rows)
    want = pv.box_smooth3d_bwd_plain(g_out, out, weight, k)
    assert got.shape == (len(rows), 4)
    assert torch.equal(got, want.view(-1, 4)[rows])
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_touched_rows_are_the_valid_corners(seed):
    verts = _verts(seed)
    want = torch.unique(torch.cat([lin[valid] for lin, _, valid in
                                   pv._corner_terms(verts, RES)]))
    got = pv.touched_rows(verts, RES)
    assert got.dtype == torch.int64
    assert torch.equal(got, want)
    # voxel_splat_bwd_plain reads nothing else: a gradient zero outside
    # the rows gives the same result as one that is not
    codes = torch.rand(V, 3)
    g_acc = torch.randn(B, RES ** 3, 4)
    only = torch.zeros_like(g_acc).view(-1, 4)
    only[got] = g_acc.view(-1, 4)[got]
    a = pv.voxel_splat_bwd_plain(verts, codes, g_acc, RES)
    b = pv.voxel_splat_bwd_plain(verts, codes, only.view(B, -1, 4), RES)
    for x, y in zip(a, b):                 # the NaN vertex's are NaN
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


@pytest.mark.parametrize("k", [2, 3, 11])
def test_rows_twin_with_ties_off_the_rows(k):
    """Ties and weights below the floor beside the rows (one voxel along x
    and along y), where only the windows' D sums read them."""
    g_out, out, weight, rows = _smooth_inputs(k, True, 40 + k)
    weight = out.new_ones(weight.shape) * 0.5
    n = weight.numel()
    near = torch.unique(torch.cat([rows + 1, rows + RES]).clamp(max=n - 1))
    off = near[~torch.isin(near, rows)]
    weight.view(-1)[off[::2]] = pv.WEIGHT_FLOOR
    weight.view(-1)[off[1::2]] = 5e-4
    assert len(off) >= 64
    got = pv.box_smooth3d_bwd_rows_plain(g_out, out, weight, k, rows)
    want = pv.box_smooth3d_bwd_plain(g_out, out, weight, k)
    assert torch.equal(got, want.view(-1, 4)[rows])


def test_box_backward_wrapper_takes_a_cube_and_its_batch():
    """On CPU tensors the backward entry is the dense twins' composition;
    it refuses a volume that is not a cube and vertices of another
    batch."""
    g_out, out, weight, _ = _smooth_inputs(3, False, 5)
    verts = _verts(5)
    codes = torch.rand(V, 3)
    before = (kv.launches_splat_bwd, kv.launches_smooth_bwd)
    got = kv._voxelize_bwd(verts, codes, g_out, out, weight, RES, 3)
    g_acc = pv.box_smooth3d_bwd_plain(g_out, out, weight, 3)
    want = pv.voxel_splat_bwd_plain(verts, codes, g_acc.view(B, -1, 4), RES)
    for x, y in zip(got, want):            # the NaN vertex's are NaN
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
    assert (kv.launches_splat_bwd, kv.launches_smooth_bwd) == before
    with pytest.raises(ValueError, match="res, res, res"):
        kv._voxelize_bwd(verts, codes, g_out[:, :, :-1], out[:, :, :-1],
                         weight[:, :, :-1], RES, 3)
    with pytest.raises(ValueError, match="res, res, res"):
        kv._voxelize_bwd(verts[:1], codes, g_out, out, weight, RES, 3)
