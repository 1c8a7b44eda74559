"""PyMAF, the demo's default human pose and shape estimator
(``icon_tpu.models.pymaf``; reference lib/pymaf)."""
