"""Metric logging (``icon_tpu.training.logging``; reference: TensorBoard
logger + progress, apps/train.py:79-81): scalars as JSONL lines and image
panels as PNG files; no TensorBoard mirror. In a process group only rank 0
writes: on the other ranks the logger is disabled."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "train",
                 enabled: bool = True):
        """``enabled`` False: a logger that writes nothing (a rank other
        than 0)."""
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._fh = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train") -> None:
        if self._fh is None:
            return
        record = {"step": int(step), "time": time.time()}
        record.update({f"{prefix}/{k}": float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def log_images(self, step: int, images: Dict[str, np.ndarray],
                   prefix: str = "train") -> Optional[str]:
        """Save a horizontal grid of [H, W, 3]-ish arrays in [-1, 1] or
        [0, 1] as ``<log_dir>/images/{prefix}_{step:07d}.png`` (the panels
        the reference posts to TensorBoard, apps/ICON.py:694-727); None
        when disabled."""
        if self._fh is None:
            return None
        from PIL import Image
        panels = []
        for arr in images.values():
            a = np.asarray(arr, np.float32)
            if a.ndim == 2:
                a = a[..., None].repeat(3, -1)
            if a.shape[-1] == 1:
                a = a.repeat(3, -1)
            if a.min() < -0.01:                     # [-1, 1] -> [0, 1]
                a = a * 0.5 + 0.5
            panels.append(np.clip(a, 0, 1))
        h = max(p.shape[0] for p in panels)
        panels = [np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)))
                  for p in panels]
        grid = np.concatenate(panels, axis=1)
        out_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{prefix}_{step:07d}.png")
        Image.fromarray((grid * 255).astype("uint8")).save(path)
        return path

    def close(self):
        if self._fh is not None:
            self._fh.close()
