"""Loading the published PARE checkpoint (``icon_tpu.models.pare.convert``;
the reference's ``pare_data/pare_checkpoint.ckpt``, a Lightning checkpoint
whose ``state_dict`` holds ``model.backbone.*`` = PoseHighResolutionNet
hrnet_w32-conv and ``model.head.*`` = PareHead).

The port's module names are the checkpoint's, so loading is ``torch.load``,
the ``model.``/``module.`` prefixes stripped and a strict
``load_state_dict``. The file's other entries are the ones the JAX
package's ``port_pare`` skips too and the port has no module for: the SMPL
buffers, the regression's ``init_*`` buffers, the backbone's pose
pretraining ``final_layer``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def _strip(key: str) -> str:
    for prefix in ("model.", "module."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def load_pare_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load ``path`` into ``net`` (a :class:`~icon_tpu_torch.models.pare.
    net.PARE`) in place and return it. Raises on any tensor of the net the
    file lacks or holds at another shape; prints how many of the file's
    entries were dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state: Dict[str, torch.Tensor] = {
        _strip(k): v for k, v in ckpt.get("state_dict", ckpt).items()}
    own = net.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} PARE tensors, e.g. "
                       f"{missing[:5]}")
    dropped = [k for k in state if k not in own]
    net.load_state_dict({k: state[k] for k in own if k in state},
                        strict=True)
    print(f"[hps] loaded {len(own)} PARE tensors from {path}; dropped "
          f"{len(dropped)} entries the port has no module for (SMPL, init "
          "and pretraining buffers)", flush=True)
    return net
