"""The pix2pixHD GlobalGenerator, backbone of the normal nets
(``icon_tpu.models.pix2pix``; reference lib/net/FBNet.py:202-317, built by
``define_G(in, 3, 64, "global", 4, 9, 1, 3, "instance")``).

Built as the reference's ``nn.Sequential`` named ``model``, so the
state-dict keys are those of the published ``normal.ckpt``. With
``n = n_downsampling`` and ``nb = n_blocks``: ``model.1`` is the 7x7 input
conv, ``model.{4+3i}`` the stride-2 convs, ``model.{4+3n+j}`` the resblocks
(``conv_block.1`` and ``conv_block.5``), ``model.{4+3n+nb+3i}`` the
transposed convs and ``model.{5+6n+nb}`` the 7x7 output conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from icon_tpu_torch.models.layers import (conv_transpose2x, make_norm,
                                          reflect_pad2d)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "instance"):
        super().__init__()
        self.conv_block = nn.Sequential(
            reflect_pad2d(1), nn.Conv2d(dim, dim, 3), make_norm(norm, dim),
            nn.ReLU(True),
            reflect_pad2d(1), nn.Conv2d(dim, dim, 3), make_norm(norm, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class GlobalGenerator(nn.Module):
    """NCHW ``[B, input_nc, H, W]`` -> ``[B, output_nc, H, W]`` (tanh);
    H and W divisible by ``2 ** n_downsampling``."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 norm: str = "instance"):
        super().__init__()
        layers = [reflect_pad2d(3), nn.Conv2d(input_nc, ngf, 7),
                  make_norm(norm, ngf), nn.ReLU(True)]
        for i in range(n_downsampling):
            c = ngf * 2 ** i
            layers += [nn.Conv2d(c, 2 * c, 3, stride=2, padding=1),
                       make_norm(norm, 2 * c), nn.ReLU(True)]
        dim = ngf * 2 ** n_downsampling
        layers += [ResnetBlock(dim, norm) for _ in range(n_blocks)]
        for i in range(n_downsampling):
            c = ngf * 2 ** (n_downsampling - i)
            layers += [conv_transpose2x(c, c // 2), make_norm(norm, c // 2),
                       nn.ReLU(True)]
        layers += [reflect_pad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
