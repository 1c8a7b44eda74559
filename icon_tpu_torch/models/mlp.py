"""Per-point occupancy regressor (``icon_tpu.models.mlp``; reference
lib/net/MLP.py).

Parameters are the reference's ``Conv1d(cin, cout, 1)`` filters and
``norms`` (state-dict keys ``filters.i.weight``, ``norms.i.running_mean``);
the forward runs them as ``F.linear`` on channel-last ``[B, N, C]`` points,
the same product without a transpose.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from icon_tpu_torch.models.layers import make_norm


class MLP(nn.Module):
    def __init__(self, filter_channels: Sequence[int],
                 res_layers: Sequence[int] = (), norm: str = "group",
                 last_sigmoid: bool = True):
        super().__init__()
        self.res_layers = tuple(res_layers)
        self.norm = norm
        self.last_sigmoid = last_sigmoid
        c0 = filter_channels[0]
        n_layers = len(filter_channels) - 1
        self.filters = nn.ModuleList()
        self.norms = nn.ModuleList()
        for i in range(n_layers):
            cin = filter_channels[i] + (c0 if i in self.res_layers else 0)
            self.filters.append(nn.Conv1d(cin, filter_channels[i + 1], 1))
            if i != n_layers - 1:
                self.norms.append(make_norm(norm, filter_channels[i + 1],
                                            dim=1))

    def _norm(self, i: int, y: torch.Tensor) -> torch.Tensor:
        if self.norm == "batch":                # per-channel: [B*N, C] is fine
            return self.norms[i](y.reshape(-1, y.shape[-1])).reshape(y.shape)
        # group norm pools over the point axis too: run it channel-first
        return self.norms[i](y.transpose(1, 2)).transpose(1, 2)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """``[B, N, C_in]`` -> ``[B, N, C_out]``."""
        y = tmpy = feature
        n_layers = len(self.filters)
        for i, f in enumerate(self.filters):
            if i in self.res_layers:
                y = torch.cat([y, tmpy], dim=-1)
            y = F.linear(y, f.weight[..., 0], f.bias)
            if i != n_layers - 1:
                y = F.leaky_relu(self._norm(i, y), 0.01)
        return torch.sigmoid(y) if self.last_sigmoid else y
