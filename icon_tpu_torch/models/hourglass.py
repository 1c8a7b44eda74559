"""Stacked-hourglass image filter (``icon_tpu.models.hourglass``; reference
lib/net/HGFilters.py). NCHW in, a list of ``num_stack`` maps
``[B, hourglass_dim, H/4, W/4]`` out."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.layers import ConvBlock, avg_pool2, make_norm
from icon_tpu_torch.ops.resize import upsample2x_bicubic


class HourGlass(nn.Module):
    """Recursive hourglass of ConvBlocks (HGFilters.py:23-79)."""

    def __init__(self, depth: int, features: int, norm: str = "group"):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(features, features, norm))
            self.add_module(f"b2_{lv}", ConvBlock(features, features, norm))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}",
                                ConvBlock(features, features, norm))
            self.add_module(f"b3_{lv}", ConvBlock(features, features, norm))

    def _level(self, x: torch.Tensor, lv: int) -> torch.Tensor:
        up1 = self._modules[f"b1_{lv}"](x)
        low1 = self._modules[f"b2_{lv}"](avg_pool2(x))
        if lv > 1:
            low2 = self._level(low1, lv - 1)
        else:
            low2 = self._modules[f"b2_plus_{lv}"](low1)
        low3 = self._modules[f"b3_{lv}"](low2)
        return up1 + upsample2x_bicubic(low3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(x, self.depth)


class HGFilter(nn.Module):
    """Stacked hourglass encoder (HGFilters.py:82-197)."""

    def __init__(self, in_dim: int, num_stack: int = 2, depth: int = 2,
                 hourglass_dim: int = 6, norm: str = "group",
                 hg_down: str = "ave_pool",
                 conv1_ksdp: Sequence[int] = (7, 2, 1, 3)):
        super().__init__()
        if hg_down != "ave_pool":
            raise NotImplementedError(
                f"hg_down {hg_down!r} is not ported (ROADMAP Queue A item 2)")
        self.num_stack = num_stack
        k, s, d, p = conv1_ksdp
        self.conv1 = nn.Conv2d(in_dim, 64, k, stride=s, dilation=d,
                               padding=p)
        self.bn1 = make_norm(norm, 64)
        self.conv2 = ConvBlock(64, 128, norm)
        self.conv3 = ConvBlock(128, 128, norm)
        self.conv4 = ConvBlock(128, 256, norm)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(depth, 256, norm))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, norm))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", make_norm(norm, 256))
            self.add_module(f"l{i}", nn.Conv2d(256, hourglass_dim, 1))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(hourglass_dim, 256, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = avg_pool2(self.conv2(x))
        x = self.conv4(self.conv3(x))
        previous, outputs = x, []
        for i in range(self.num_stack):
            hg = self._modules[f"m{i}"](previous)
            ll = self._modules[f"top_m_{i}"](hg)
            ll = F.relu(self._modules[f"bn_end{i}"](
                self._modules[f"conv_last{i}"](ll)))
            tmp_out = self._modules[f"l{i}"](ll)
            outputs.append(tmp_out)
            if i < self.num_stack - 1:
                previous = previous + self._modules[f"bl{i}"](ll) + \
                    self._modules[f"al{i}"](tmp_out)
        return outputs
