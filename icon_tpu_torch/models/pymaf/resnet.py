"""ResNet-50 backbone of PyMAF (``icon_tpu.models.pymaf.resnet``; reference
lib/pymaf/models/hmr.py:63-174).

torchvision's bottleneck stack with torchvision's key names (``conv1``,
``bn1``, ``layer{s}.{i}.conv{c}``, ``layer{s}.{i}.downsample.{0,1}``), so a
published checkpoint loads by name. Returns the stage-4 feature map and its
global average pool, ``ResNet_Backbone.forward``'s ``(x_featmap, xf)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * self.expansion, 1, stride=stride,
                      bias=False),
            nn.BatchNorm2d(planes * self.expansion)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class ResNetBackbone(nn.Module):
    """``layers`` (3, 4, 6, 3) is ResNet-50; ``width`` scales the channels
    (64 published)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = width
        for si, n in enumerate(layers):
            planes = width * 2 ** si
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(
                    inplanes, planes, stride=1 if si == 0 or bi else 2,
                    downsample=bi == 0))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        self.n_stages = len(layers)
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, 3, H, W]`` -> (s_feat ``[B, 32 * width, H/32, W/32]``,
        g_feat ``[B, 32 * width]``)."""
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for si in range(self.n_stages):
            x = getattr(self, f"layer{si + 1}")(x)
        return x, x.mean(dim=(2, 3))
