"""Networks of the serving frame (counterparts of ``icon_tpu.models``)."""
