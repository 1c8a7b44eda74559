"""VGG19 perceptual features and loss (``icon_tpu.models.vgg``; reference
lib/net/net_util.py:283-329).

The reference's ``VGGLoss`` runs torchvision's pretrained VGG19 over five
relu slices (relu1_1 .. relu5_1) and L1-compares them with the weights
1/32, 1/16, 1/8, 1/4 and 1. It adds to the *value* of the NormalNet's loss
under ``no_grad`` (NormalNet.py:113-120), which drives the validation-loss
checkpoint selection.

:class:`Vgg19Features` holds its 13 convolutions at torchvision's
``features.{i}`` indices, so the published ``vgg19-dcbb9e9d.pth`` loads by
name (:func:`load_vgg19`). Inputs are NHWC in [-1, 1], without ImageNet
normalization, as the reference and the JAX function take them; the 2x2
max-pools floor odd sizes.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision VGG19 `features` conv indices and their output channels;
# the five slice boundaries are the reference's relu1_1/2_1/3_1/4_1/5_1
_CONV_CH = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256,
            16: 256, 19: 512, 21: 512, 23: 512, 25: 512, 28: 512}
_SLICE_END = (0, 5, 10, 19, 28)       # conv index whose relu ends each slice
_POOL_BEFORE = (5, 10, 19, 28)        # maxpool precedes these convs
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

DEFAULT_VGG_PATH = "data/vgg/vgg19.pth"


class Vgg19Features(nn.Module):
    """The five relu-slice feature maps of NHWC ``x``, NCHW."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        cin = 3
        for i, ch in _CONV_CH.items():
            self.features[str(i)] = nn.Conv2d(cin, ch, 3, padding=1)
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        h = x.permute(0, 3, 1, 2)
        for i in _CONV_CH:
            if i in _POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(self.features[str(i)](h))
            if i in _SLICE_END:
                outs.append(h)
        return outs


def vgg_perceptual_loss(vgg: Vgg19Features, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Reference VGGLoss.forward: the weighted L1 over the five slices."""
    loss = 0.0
    for w, a, b in zip(VGG_WEIGHTS, vgg(x), vgg(y)):
        loss = loss + w * torch.mean(torch.abs(a - b))
    return loss


def load_vgg19(path: Optional[str] = None, device="cpu"
               ) -> Optional[Vgg19Features]:
    """:class:`Vgg19Features` with torchvision's VGG19 weights from
    ``path`` (default ``data/vgg/vgg19.pth``) on ``device``, in eval mode;
    ``None`` when the file is absent (the trainer then says that the
    perceptual term is left out). The 13 convolutions of the five slices
    load strictly by name; the file's later convolutions
    (``features.30`` .. ``features.34``) and its ``classifier.*`` are not
    read."""
    path = path or DEFAULT_VGG_PATH
    if not osp.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = Vgg19Features()
    net.load_state_dict({k: sd[k] for k in net.state_dict()}, strict=True)
    return net.to(device).eval().requires_grad_(False)
