"""SMPL-family body models (``icon_tpu.models.smplx``): linear blend
skinning (``lbs``) and the ``BodyModel`` module with its asset loader and
synthetic models (``body``)."""
