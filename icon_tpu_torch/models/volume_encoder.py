"""3D CNN over PaMIR's semantic voxel volume (``icon_tpu.models.
volume_encoder``; reference lib/net/VE.py).

Input ``[B, 3, D, H, W]`` (the 128^3 semantic volume, NCDHW), output a list
of ``num_stacks`` maps ``[B, num_out, D/4, H/4, W/4]``: two stride-2 dilated
5^3 convolutions, then ``Residual3D`` stacks, on cuDNN. The modules carry
the reference's names (``conv1``, ``bn1``, ``conv2``, ``bn2``,
``res{i}.conv1/bn1/conv2/bn2/conv4``), so the published ``pamir.ckpt``'s
``netG.ve.*`` tensors load by name; the modules the reference registers but
never runs (``conv_out1``, ``conv_out2``, ``res{i}.bn``, ``res{i}.conv3``)
are left out. Its BatchNorms keep flax's default momentum, 0.99, which is
torch's 0.01, and flax's running statistics (``layers.BatchNorm3d``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.layers import BatchNorm3d


def _bn(channels: int) -> BatchNorm3d:
    return BatchNorm3d(channels, momentum=0.01)


class Residual3D(nn.Module):
    def __init__(self, num_in: int, num_out: int):
        super().__init__()
        self.conv1 = nn.Conv3d(num_in, num_out, 3, padding=2, dilation=2)
        self.bn1 = _bn(num_out)
        self.conv2 = nn.Conv3d(num_out, num_out, 3, padding=1)
        self.bn2 = _bn(num_out)
        self.conv4 = nn.Conv3d(num_in, num_out, 1) if num_in != num_out \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return out + (x if self.conv4 is None else self.conv4(x))


class VolumeEncoder(nn.Module):
    def __init__(self, num_in: int = 3, num_out: int = 32,
                 num_stacks: int = 2, num_inter: int = 8):
        super().__init__()
        self.num_stacks = num_stacks
        self.conv1 = nn.Conv3d(num_in, num_inter, 5, stride=2, padding=4,
                               dilation=2)
        self.bn1 = _bn(num_inter)
        self.conv2 = nn.Conv3d(num_inter, num_out, 5, stride=2, padding=4,
                               dilation=2)
        self.bn2 = _bn(num_out)
        for i in range(num_stacks):
            self.add_module(f"res{i}", Residual3D(num_out, num_out))

    def forward(self, x: torch.Tensor, intermediate_output: bool = False
                ) -> List[torch.Tensor]:
        """The stacks' outputs, or with ``intermediate_output`` False (the
        eval mode's choice) only the last."""
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        outs = []
        for i in range(self.num_stacks):
            out = self._modules[f"res{i}"](out)
            outs.append(out)
        return outs if intermediate_output else outs[-1:]
