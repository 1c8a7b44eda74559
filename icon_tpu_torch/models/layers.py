"""Shared layer primitives (``icon_tpu.models.layers``; reference
``ConvBlock``/``get_norm_layer``, lib/net/net_util.py:196-280).

Modules are NCHW and carry the reference's torch state-dict names, so a
published checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.parallel import dist


class _FlaxRunningStats:
    """Training-mode BatchNorm as flax's ``BatchNorm`` computes it: mean =
    E[x], the *biased* variance E[x^2] - E[x]^2 (flax's fast variance),
    both for the normalization and for the running statistics (torch's own
    update takes the unbiased variance). Eval mode is torch's. A torch
    ``momentum`` m is flax's ``1 - m``.

    The moments are the global batch's: each rank's per-channel sums of x
    and x^2 and its count go through one differentiable all-reduce
    (``parallel/dist.py``; the identity without a group of several), as
    the JAX trainer's BatchNorm takes them on a sharded batch, so every
    rank normalizes and updates by the same statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        count = x.new_full((1,), x.numel() // c)
        sums = dist.all_reduce_sum(torch.cat([x.sum(dims),
                                              (x * x).sum(dims), count]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        shape = [1, c] + [1] * (x.dim() - 2)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        self._update(mean.detach(), var.detach())
        return y

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked += 1


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    pass


def make_norm(norm: str, channels: int, dim: int = 2) -> nn.Module:
    """group -> GroupNorm(32, eps 1e-5); batch -> BatchNorm{1,2}d (eps 1e-5,
    momentum 0.1, the torch twin of flax's 0.9; running stats as flax
    updates them); instance ->
    InstanceNorm2d without affine or running stats (eps 1e-5); none ->
    the identity, which holds no tensors."""
    if norm == "group":
        return nn.GroupNorm(32, channels, eps=1e-5)
    if norm == "batch":
        cls = BatchNorm2d if dim == 2 else BatchNorm1d
        return cls(channels, eps=1e-5)
    if norm == "instance":
        return nn.InstanceNorm2d(channels, eps=1e-5, affine=False)
    if norm in ("none", None):
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


class ConvBlock(nn.Module):
    """The hourglass residual block: three 3x3 convs giving C/2 + C/4 + C/4
    channels, concatenated, plus a (norm, relu, 1x1) shortcut when the
    channel counts differ. ``bn4`` is registered even when unused and the
    shortcut aliases it as ``downsample.0``, as in the reference, so the
    state-dict keys match the published checkpoints."""

    def __init__(self, in_planes: int, out_planes: int, norm: str = "group"):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.conv1 = nn.Conv2d(in_planes, half, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(half, quarter, 3, padding=1, bias=False)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, padding=1, bias=False)
        self.bn1 = make_norm(norm, in_planes)
        self.bn2 = make_norm(norm, half)
        self.bn3 = make_norm(norm, quarter)
        self.bn4 = make_norm(norm, in_planes)
        if in_planes != out_planes:
            self.downsample = nn.Sequential(
                self.bn4, nn.ReLU(True),
                nn.Conv2d(in_planes, out_planes, 1, bias=False))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        res = x if self.downsample is None else self.downsample(x)
        return out + res


def reflect_pad2d(pad: int) -> nn.ReflectionPad2d:
    """Reflection padding by ``pad`` on each side of H and W (NCHW), the
    JAX package's ``reflect_pad2d``."""
    return nn.ReflectionPad2d(pad)


def conv_transpose2x(cin: int, cout: int) -> nn.ConvTranspose2d:
    """The pix2pixHD upsampling layer, ConvTranspose2d(k=3, s=2, p=1,
    output_padding=1): an exact 2x upsample (the JAX package's
    ``ConvTranspose2dTorch``)."""
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                              output_padding=1)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 2, stride=2)`` on NCHW."""
    return F.avg_pool2d(x, 2, stride=2)
