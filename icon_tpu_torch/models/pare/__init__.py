"""PARE, the part-attention human pose and shape estimator
(``icon_tpu.models.pare``; reference lib/pare)."""
