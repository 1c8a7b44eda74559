"""The indexed marcher's buffer sizes on the host, with no card and no JAX:
``kernels/marching.py``'s scan scratch of ``mt_emit`` and the bitmap,
summary, scan and rank buffers of ``mt_index``. The kernels themselves are
held to the plain versions on the card (``test_torch_marching_cuda.py``).
"""

import pytest

from icon_tpu_torch.kernels import marching as km


@pytest.mark.parametrize("nc", [1, 31, 32, 33, 1 << 18])
def test_emit_scratch_words(nc):
    assert km.emit_scratch_words(nc) == 1 + -(-nc // km.EMIT_TILE_CELLS)
    assert (km.emit_scratch_words(nc) - 1) * km.EMIT_TILE_CELLS >= nc


@pytest.mark.parametrize("shape,max_tris", [
    ((2, 2, 2), 1), ((17, 19, 23), 4096), ((64, 64, 64), 1 << 16),
    ((256, 256, 256), 1 << 20), ((512, 512, 512), 1 << 21)])
def test_index_sizes(shape, max_tris):
    """The summary is a bit a bitmap word (D H W 8 / 1024 words, 0.52 MB at
    256^3); the bitmap covers every edge id; the scan holds a status a
    tile; the touched words' ranks hold at most a live slot each."""
    D, H, W = shape
    sz = km.index_sizes(max_tris, shape)
    ids = D * H * W * 8
    assert sz["summary"] == -(-ids // 1024)
    assert sz["bitmap"] == 32 * sz["summary"] >= -(-ids // 32)
    assert sz["scan"] == 1 + -(-sz["summary"] // km.SCAN_TILE_WORDS)
    assert sz["touched"] == min(3 * max_tris, sz["bitmap"])
    if shape == (256, 256, 256):
        assert sz["summary"] * 4 == 524288
