"""Loading the published HybrIK checkpoint (``icon_tpu.models.hybrik.
convert``; the reference's ``hybrik_data/pretrained_w_cam.pth``, the state
dict of simple3dpose.py:42-125 HybrIKBaseSMPLCam).

The port's :class:`~icon_tpu_torch.models.hybrik.net.HybrIK` names its
modules as the file does (``preact.*``, ``deconv_layers.{0,1,3,4,6,7}``,
``final_layer``, ``fc1``, ``fc2``, ``decshape``, ``decphi``, ``deccam``,
the ``init_shape`` buffer), and loading is strict: a tensor the net lacks,
a tensor the file lacks or one at another shape raises. Dropped, and
counted: the SMPL layer's buffers (``smpl.*``: the template, the blend
shapes, the joint regressors and the kinematic tables; the port takes the
body from its own loaders) and ``init_cam`` (the constant (0.9, 0, 0), as
in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _dropped(key: str) -> bool:
    return key.startswith("smpl.") or key == "init_cam"


def load_hybrik_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load ``path`` into ``net`` (a :class:`~icon_tpu_torch.models.hybrik.
    net.HybrIK`) in place and return it. Raises KeyError on an entry with
    no place in the net and on a tensor of the net the file lacks, and
    RuntimeError on a size mismatch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = {k.replace("module.", ""): v
             for k, v in ckpt.get("state_dict", ckpt).items()}
    dropped = [k for k in state if _dropped(k)]
    state = {k: v for k, v in state.items() if not _dropped(k)}
    own = net.state_dict()
    unknown = [k for k in state if k not in own]
    if unknown:
        raise KeyError(f"{path}: {len(unknown)} entries have no place in "
                       f"the port's HybrIK, e.g. {unknown[:5]}")
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} HybrIK tensors, e.g. "
                       f"{missing[:5]}")
    net.load_state_dict({k: state.get(k, v) for k, v in own.items()},
                        strict=True)
    print(f"[hps] loaded {len(state)} HybrIK tensors from {path}; dropped "
          f"{len(dropped)} entries (the SMPL layer's buffers, init_cam)",
          flush=True)
    return net
