"""HybrIK, 3D heatmaps with the analytic twist-and-swing IK
(``icon_tpu.models.hybrik``; reference lib/hybrik)."""
