"""Stateless tensor ops (counterparts of ``icon_tpu.ops``)."""
