"""HRNet-W48 body encoder of PIXIE (``icon_tpu.models.pixie.hrnet``;
reference lib/pixielib/models/hrnet.py:14-34 ``load_HRNet`` and
encoders.py:51-72 ``HRNEncoder``).

PARE's multi-resolution trunk (``models/pare/hrnet.py:HRTrunk``, stage
modules 1/4/3) at W48, then the 'concat' head: each branch but the last
marches to the 1/32 grid through stride-2 (conv with bias, BN, ReLU) steps
that double its channels (``subsample_{4,3,2}``, hrnet.py:381-395), the
four are concatenated (32 width channels), five bottlenecks whose residual
is a bare 1x1 conv (``conv_layers``, hrnet.py:368-379) lift them to the
feature width, and a global mean pool gives the 2,048-d feature
(hrnet.py:470-490). The module names are ``Encoder_body.encoder.*`` of the
published ``pixie_model.tar``. Channel-first.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.pare.hrnet import HRTrunk


class HeadBottleneck(nn.Module):
    """A bottleneck whose residual is a bare 1x1 conv, no BN (the
    reference's ``_make_conv_layer`` passes ``nn.Conv2d`` as the
    downsample)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Conv2d(inplanes, planes * 4, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + self.downsample(x))


class PixieHRNet(HRTrunk):
    """HRNet-W{width} with PIXIE's 'concat' head: ``[B, 3, H, W]`` ->
    ``[B, feat_dim]``."""

    def __init__(self, width: int = 48, stem: int = 64, feat_dim: int = 2048,
                 stage_modules: Sequence[int] = (1, 4, 3)):
        super().__init__(width, stage_modules, stem)
        for b, steps in ((0, 3), (1, 2), (2, 1)):
            layers, c = [], self.widths[b]
            for _ in range(steps):
                layers += [nn.Conv2d(c, 2 * c, 3, stride=2, padding=1),
                           nn.BatchNorm2d(2 * c), nn.ReLU()]
                c *= 2
            self.add_module(f"subsample_{4 - b}", nn.Sequential(*layers))
        c = 4 * self.widths[3]
        blocks = []
        for _ in range(5):
            blocks.append(HeadBottleneck(c, feat_dim // 4))
            c = feat_dim
        self.conv_layers = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.trunk(x)
        h = torch.cat([self.subsample_4(xs[0]), self.subsample_3(xs[1]),
                       self.subsample_2(xs[2]), xs[3]], 1)
        return self.conv_layers(h).mean(dim=(2, 3))
