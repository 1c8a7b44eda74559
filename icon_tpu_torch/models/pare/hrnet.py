"""HRNet backbone of PARE (``icon_tpu.models.pare.hrnet``; reference
lib/pare/pare/models/backbone/hrnet.py, PoseHighResolutionNet with
DOWNSAMPLE=False, USE_CONV=True).

A stem downsamples 4x; parallel branches at 1/4 .. 1/32 resolution exchange
features through fuse layers after every module. The '-conv' variant that
PARE deploys climbs each lower branch to the 1/4 grid through learned
(bilinear align_corners x2 -> conv3x3 -> BN -> ReLU) steps and concatenates
all four (15 * width channels: 480 at 56^2 for a 224^2 input with W32).
The module names are the published checkpoint's (``conv1``, ``layer1.k``,
``transition{1,2,3}``, ``stage{2,3,4}.m.branches / fuse_layers``,
``upsample_stage_{2,3,4}``). The trunk (:class:`HRTrunk`) also carries
PIXIE's HRNet-W48 (``models/pixie/hrnet.py``). Channel-first inside.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.ops.resize import resize2d_bilinear_align_corners


def _conv_bn(cin: int, cout: int, k: int = 3, stride: int = 1,
             relu: bool = True) -> List[nn.Module]:
    layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                        bias=False), nn.BatchNorm2d(cout)]
    return layers + [nn.ReLU()] if relu else layers


class BasicBlock(nn.Module):
    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            *_conv_bn(inplanes, planes * 4, 1, relu=False)) \
            if downsample else None

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + res)


class HRModule(nn.Module):
    """One exchange module: ``num_blocks`` BasicBlocks per branch, then the
    full fuse (every output branch sums every branch, resampled: a 1x1 conv
    and nearest upsampling from below, stride-2 3x3 convs from above)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(channels[b])
                            for _ in range(num_blocks)]) for b in range(n))
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(*_conv_bn(
                        channels[j], channels[i], 1, relu=False)))
                elif j < i:
                    steps = []
                    for s in range(i - j):
                        last = s == i - j - 1
                        cout = channels[i] if last else channels[j]
                        steps.append(nn.Sequential(*_conv_bn(
                            channels[j], cout, 3, 2, relu=not last)))
                    row.append(nn.Sequential(*steps))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = [br(x) for br, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, f in enumerate(row):
                h = outs[j] if f is None else f(outs[j])
                if j > i:
                    h = F.interpolate(h, size=outs[i].shape[2:],
                                      mode="nearest")
                acc = h if acc is None else acc + h
            fused.append(F.relu(acc))
        return fused


class HRTrunk(nn.Module):
    """The multi-resolution trunk shared by PARE's and PIXIE's HRNets:
    ``[B, 3, H, W]`` -> the four branches at 1/4 .. 1/32 with ``width``,
    ``2 width``, ``4 width`` and ``8 width`` channels; ``stem`` channels in
    the stem (64 published)."""

    def __init__(self, width: int = 32,
                 stage_modules: Sequence[int] = (1, 4, 3), stem: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, stem, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(stem)
        self.conv2 = nn.Conv2d(stem, stem, 3, stride=2, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(stem)
        self.layer1 = nn.Sequential(
            Bottleneck(stem, stem, downsample=True),
            *[Bottleneck(4 * stem, stem) for _ in range(3)])
        w = (width, 2 * width, 4 * width, 8 * width)
        self.widths = w
        self.transition1 = nn.ModuleList([
            nn.Sequential(*_conv_bn(4 * stem, w[0])),
            nn.Sequential(nn.Sequential(*_conv_bn(4 * stem, w[1], 3, 2)))])
        self.stage2 = nn.Sequential(*[HRModule(w[:2])
                                      for _ in range(stage_modules[0])])
        self.transition2 = nn.ModuleList([None, None, nn.Sequential(
            nn.Sequential(*_conv_bn(w[1], w[2], 3, 2)))])
        self.stage3 = nn.Sequential(*[HRModule(w[:3])
                                      for _ in range(stage_modules[1])])
        self.transition3 = nn.ModuleList([None, None, None, nn.Sequential(
            nn.Sequential(*_conv_bn(w[2], w[3], 3, 2)))])
        self.stage4 = nn.Sequential(*[HRModule(w)
                                      for _ in range(stage_modules[2])])

    def trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [self.transition1[0](x), self.transition1[1](x)]
        for m in self.stage2:
            xs = m(xs)
        xs = xs + [self.transition2[2](xs[-1])]
        for m in self.stage3:
            xs = m(xs)
        xs = xs + [self.transition3[3](xs[-1])]
        for m in self.stage4:
            xs = m(xs)
        return xs


class HRNet(HRTrunk):
    """HRNet-W{width} with the '-conv' head: ``[B, 3, H, W]`` -> ``[B, 15 *
    width, H/4, W/4]``."""

    def __init__(self, width: int = 32,
                 stage_modules: Sequence[int] = (1, 4, 3)):
        super().__init__(width, stage_modules)
        w = self.widths
        # upsample_stage_{b+1}: b steps of (Upsample, conv, bn, relu); the
        # Upsample slots carry no weights and are applied in the forward
        for b in range(1, 4):
            layers: List[nn.Module] = []
            for _ in range(b):
                layers += [nn.Identity(), *_conv_bn(w[b], w[b])]
            self.add_module(f"upsample_stage_{b + 1}",
                            nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.trunk(x)
        ups = [xs[0]]
        for b in range(1, 4):
            h = xs[b]
            for i, layer in enumerate(getattr(self,
                                              f"upsample_stage_{b + 1}")):
                if i % 4 == 0:
                    h = resize2d_bilinear_align_corners(
                        h, (2 * h.shape[2], 2 * h.shape[3]))
                else:
                    h = layer(h)
            ups.append(h)
        return torch.cat(ups, 1)
