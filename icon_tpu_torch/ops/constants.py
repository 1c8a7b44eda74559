"""Small constant tensors, made once a device.

``torch.tensor(values, device=card)`` copies from pageable host memory,
and such a copy waits for the stream: a serving frame that made its
constants that way on every call could never run ahead of the card. The
hot paths take theirs from :func:`device_constant` instead, which copies
them on the first call only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_cache: Dict[tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made on the
    first call for these values and returned again after: the caller must
    not write into it."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.shape, arr.dtype.str, arr.tobytes(), dtype, device)
    out = _cache.get(key)
    if out is None:
        out = torch.as_tensor(arr, dtype=dtype, device=device)
        _cache[key] = out
    return out
