"""The serving frame's non-blocking dispatch on the card: a warm
``compute()`` raises nothing under ``torch.cuda.set_sync_debug_mode
("error")`` (no copy from pageable memory, no read of a count, no wait);
the packed mesh's pinned host copy decodes to the bytes and mesh of the
blocking ``buf.cpu()`` path; ``serve`` gives ``frame()``'s meshes.

Needs a CUDA card and nvcc, and imports no JAX: ``python -m pytest
tests/test_torch_serve_cuda.py --noconftest -m cuda -q``. Where no card
exists the tests skip."""

import numpy as np
import pytest
import torch

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
    token, mesh, _ = frame.compute()
    (copy, nvb, ncb), out, (H, W) = token
    host = copy.wait()
    assert host.is_pinned()
    again, nvb2, ncb2 = PM.pack_lattice(out, sizes=(nvb, ncb),
                                        implicit_eid=True)
    assert (nvb2, ncb2) == (nvb, ncb)
    blocking = again.cpu().numpy()
    assert host.numpy().tobytes() == blocking.tobytes()
    v, f, overflow = frame.marcher.decode(token)
    vb, fb = PM.decode_lattice((again, nvb, ncb), H, W)
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
