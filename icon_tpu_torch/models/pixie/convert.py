"""Loading the published PIXIE checkpoint (``icon_tpu.models.pixie.convert``;
the reference's ``pixie_data/pixie_model.tar``, read at
lib/pixielib/pixie.py:125-133).

The file is a dict of per-module state dicts: ``Encoder_body`` (the
HRNet-W48 under ``encoder.``), ``Encoder_{head,hand}`` (the ResNet-50s
under ``encoder.``), ``Regressor_{body,head,head_share,hand,hand_share}``,
``Extractor_{head,left_hand,right_hand}_share`` and
``Moderator_{head,hand}_share``. The port's :class:`~icon_tpu_torch.models.
pixie.net.PIXIE` names its modules so, and loading is strict: a tensor the
net lacks, a tensor the file lacks or one at another shape raises. The one
kind of entry dropped is the encoders' ``MEAN``/``STD`` buffers, the
ImageNet constants the port keeps out of its state (the JAX package's
``port_pixie`` instead skips every name it cannot place).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

NORMALIZATION = ("MEAN", "STD")


def load_pixie_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load ``path`` into ``net`` (a :class:`~icon_tpu_torch.models.pixie.
    net.PIXIE`) in place and return it. Raises KeyError on an entry with no
    place in the net and on a tensor of the net the file lacks, and
    RuntimeError on a size mismatch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state: Dict[str, torch.Tensor] = {}
    dropped = 0
    for module, sd in ckpt.items():
        if not hasattr(sd, "items"):
            continue                        # metadata, no tensors
        for k, v in sd.items():
            k = k.replace("module.", "")
            if module.startswith("Encoder_") and k in NORMALIZATION:
                dropped += 1
                continue
            state[f"{module}.{k}"] = v
    own = net.state_dict()
    unknown = [k for k in state if k not in own]
    if unknown:
        raise KeyError(f"{path}: {len(unknown)} entries have no place in "
                       f"the port's PIXIE, e.g. {unknown[:5]}")
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} PIXIE tensors, e.g. "
                       f"{missing[:5]}")
    net.load_state_dict({k: state.get(k, v) for k, v in own.items()},
                        strict=True)
    print(f"[hps] loaded {len(state)} PIXIE tensors from {path}; dropped "
          f"the encoders' {dropped} MEAN/STD buffers (ImageNet constants)",
          flush=True)
    return net
