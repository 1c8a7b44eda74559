"""PIXIE, the whole-body SMPL-X estimator with part experts
(``icon_tpu.models.pixie``; reference lib/pixielib)."""
