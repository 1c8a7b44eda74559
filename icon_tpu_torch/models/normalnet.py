"""Front/back clothed-normal prediction (``icon_tpu.models.normalnet``;
reference lib/net/NormalNet.py:74-99).

Two GlobalGenerators: ``netF`` sees ``[image, T_normal_F]`` and ``netB``
``[image, T_normal_B]`` (the ``in_nml`` entries named ``image`` or holding
``_F`` / ``_B``). Each output is divided by ``sqrt(sum(n^2) + 1e-12)`` and
multiplied by the image foreground mask ``sum(|image|) != 0``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from icon_tpu_torch.models.pix2pix import GlobalGenerator


class NormalNet(nn.Module):
    def __init__(self, in_nml: Sequence[Tuple[str, int]] = (
            ("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)),
                 ngf: int = 64, n_downsampling: int = 4, n_blocks: int = 9):
        super().__init__()
        self.front_keys = [n for n, _ in in_nml if "_F" in n or n == "image"]
        self.back_keys = [n for n, _ in in_nml if "_B" in n or n == "image"]
        dims = dict(in_nml)
        if "image" not in dims:        # the foreground mask reads it
            raise ValueError(f"in_nml {tuple(in_nml)} has no image")
        kw = dict(ngf=ngf, n_downsampling=n_downsampling, n_blocks=n_blocks)
        self.netF = GlobalGenerator(
            sum(dims[k] for k in self.front_keys), **kw)
        self.netB = GlobalGenerator(
            sum(dims[k] for k in self.back_keys), **kw)

    def forward(self, in_tensor: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC inputs -> (normal_F, normal_B), each ``[B, H, W, 3]``."""
        def run(net, keys):
            x = torch.cat([in_tensor[k] for k in keys], dim=-1)
            n = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)
                                  + 1e-12)

        nml_f = run(self.netF, self.front_keys)
        nml_b = run(self.netB, self.back_keys)
        mask = (torch.sum(torch.abs(in_tensor["image"]), dim=-1,
                          keepdim=True) != 0.0).to(nml_f.dtype)
        return nml_f * mask, nml_b * mask
