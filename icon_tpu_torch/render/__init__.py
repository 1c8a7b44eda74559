"""Rendering over the tile rasterizer (counterparts of ``icon_tpu.render``:
the reference's lib/common/render.py without PyTorch3D)."""
