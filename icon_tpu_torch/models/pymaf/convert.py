"""Loading the published PyMAF checkpoint (``icon_tpu.models.pymaf.convert``;
the reference's ``pymaf_data/PyMAF_model_checkpoint.pt``).

The port's module names are the checkpoint's, so loading is ``torch.load``,
the ``model.``/``module.`` prefixes stripped and a ``load_state_dict`` of
the entries the port has. The file's other entries are the ones the JAX
package's converter skips too: the SMPL buffers, the IUV head, the grid and
downsample buffers and the regressors' mean-parameter buffers (the port,
like the JAX package, takes those from the asset files).
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


def load_pymaf_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load ``path`` into ``net`` (a :class:`~icon_tpu_torch.models.pymaf.
    net.PyMAF`) in place and return it. Raises on any tensor of the net
    the file lacks or holds at another shape; prints how many of the file's
    entries were dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state: Dict[str, torch.Tensor] = {
        _strip(k): v for k, v in ckpt.get("state_dict", ckpt).items()}
    own = net.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} PyMAF tensors, e.g. "
                       f"{missing[:5]}")
    dropped = [k for k in state if k not in own]
    net.load_state_dict({k: state[k] for k in own}, strict=True)
    print(f"[hps] loaded {len(own)} PyMAF tensors from {path}; dropped "
          f"{len(dropped)} entries the port has no module for (SMPL, IUV "
          "head, constant buffers)", flush=True)
    return net
