"""The demo's per-image optimization loops (``icon_tpu.infer``)."""
