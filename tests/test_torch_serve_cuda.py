"""The serving frames' non-blocking dispatch on the card: a warm
``compute()`` of the plain frame and of the NormalNet frame raises nothing
under ``torch.cuda.set_sync_debug_mode("error")`` (no copy from pageable
memory, no read of a count, no wait); the mesh decoded on the card and
copied to pinned memory holds the bytes of a blocking decode and the host
decoder's mesh; ``serve`` gives ``frame()``'s meshes.

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_serve_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import numpy as np
import pytest
import torch

from icon_tpu_torch.kernels import lattice as kl
from icon_tpu_torch.recon import marching as PM

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame's kernels have no CPU "
                    "mode")
    from icon_tpu_torch.recon.frame import (bench_config, build_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(0), B=1,
                                 image_size=64, n_samples=64, subdiv=3)
    fr = build_frame(cfg, seeded_state(cfg, 0), batch, 128, "cuda")
    for _ in range(3):                  # the buckets settle
        fr.frame()
    return fr


def test_warm_compute_never_waits(frame):
    tokens = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            tokens.append(frame.compute())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, _, verts, faces = frame.frame()
    for token, _, _ in tokens:
        v, f = frame.marcher.unpack(token)
        np.testing.assert_array_equal(f, faces)
        np.testing.assert_array_equal(v, verts)
    assert len(faces) > 10000


def test_pinned_decode_equals_blocking_decode(frame):
    """The card decodes the frame's lattice (``lattice_decode``): the
    pinned copy of its buffer holds the bytes of a blocking decode of the
    same march, and its mesh is the host decoder's on that march."""
    token, mesh, _ = frame.compute()
    (copy, nvb, nfb), out, meta = token
    assert meta is PM._DECODED
    host = copy.wait()
    assert host.is_pinned()
    nv, nf = int(host[0]), int(host[1])
    assert nv <= nvb and nf <= nfb
    blocking = kl.lattice_decode(out, nvb, nfb).cpu()
    # the header and the rows its counts cover (rows past them are unset)
    vo, fo = kl.HEADER + 3 * nv, kl.HEADER + 3 * nvb
    assert host[:vo].numpy().tobytes() == blocking[:vo].numpy().tobytes()
    assert torch.equal(host[fo:fo + 3 * nf], blocking[fo:fo + 3 * nf])
    v, f, overflow = frame.marcher.decode(token)
    H, W = out.grid_shape[1:]
    vb, fb = PM.decode_lattice(PM.pack_lattice(out), H, W)
    assert not overflow and len(f) > 10000
    np.testing.assert_array_equal(f, fb)
    np.testing.assert_array_equal(v, vb)


def test_serve_equals_frame(frame):
    served = frame.serve(6)
    stats, _, verts, faces = frame.frame()
    assert len(served) == 6
    for s, v, f in served:
        assert int(s["level1_points"]) == int(stats["level1_points"])
        assert int(s["level1_overflow"]) == 0
        np.testing.assert_array_equal(f, faces)
        np.testing.assert_array_equal(v, verts)


@pytest.fixture(scope="module")
def normalnet_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame's kernels have no CPU "
                    "mode")
    from icon_tpu_torch.recon.frame import (bench_config,
                                            build_normalnet_frame,
                                            seeded_state)
    from icon_tpu_torch.utils.synthetic import synthetic_icon_batch
    cfg = bench_config()
    batch = synthetic_icon_batch(np.random.RandomState(1), B=1,
                                 image_size=64, n_samples=8, subdiv=3)
    fr = build_normalnet_frame(cfg, seeded_state(cfg, 1, normal_net=True),
                               batch, 128, "cuda")
    for _ in range(3):                  # the buckets settle
        fr.frame()
    return fr


def test_warm_normalnet_compute_never_waits(normalnet_frame):
    """The NormalNet frame's render, body prep and visibility take their
    constants from ``device_constant`` and fill on the device, so a warm
    ``compute()`` makes no synchronizing call either."""
    tokens = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            tokens.append(normalnet_frame.compute())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, _, verts, faces = normalnet_frame.frame()
    for token, _, _ in tokens:
        v, f = normalnet_frame.marcher.unpack(token)
        np.testing.assert_array_equal(f, faces)
        np.testing.assert_array_equal(v, verts)
    assert len(faces) > 1000
