"""Data-parallel training and point-parallel recon (``icon_tpu.parallel``).

- data parallel: one process a card on ``torch.distributed``
  (``parallel/dist.py``); each rank loads its contiguous slice of the
  global batch, the gradients are averaged in one all-reduce a step and
  BatchNorm takes the global batch's moments (the reference's DDP with
  ``sync_batchnorm``, apps/train.py:117-121);
- point parallel: the recon engine's queries split along the point axis
  over a mesh of devices (:func:`shard_query`).

The JAX package's ``data_sharding`` (a ``NamedSharding``) and
``replicate`` (a replicated ``jax.Array``) have no counterpart: a rank's
slice is :func:`shard_batch`'s, and a module is copied to a device by
:class:`Replicas`.
"""

from icon_tpu_torch.parallel.mesh import (Replicas, make_mesh,
                                          make_mesh_for_batch, shard_batch,
                                          shard_points, shard_query)
