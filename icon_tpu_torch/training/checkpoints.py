"""Checkpoints as torch files (``icon_tpu.training.checkpoints``; reference
apps/train.py:30-61, 90-98, 166-229).

A checkpoint ``ckpt_{step}.pt`` holds the step, the model's state dict
(parameters and BatchNorm statistics) without the frozen NormalNet
(``normal_filter.*``, which ships in its own file) and the optimizer's
state, so ``-resume`` continues the loss curve where it stopped.
:class:`CheckpointManager` keeps the top 3 by validation loss plus the
latest (the reference's ModelCheckpoint(save_top_k=3)).
:func:`partial_warm_start` loads only the entries that match by name and
shape, with optional renames of the top-level scope (the normal network's
``netG -> normal_filter``). The JAX package's orbax directories are not
read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch

STRIP_SCOPES = ("normal_filter",)


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module,
                    optimizer=None, strip_frozen: bool = True) -> str:
    """Write ``{ckpt_dir}/ckpt_{step}.pt``; returns its path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"ckpt_{step}.pt")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if not (strip_frozen and k.split(".")[0] in STRIP_SCOPES)}
    payload = {"step": int(step), "state_dict": state}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(payload, path)
    return path


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def partial_warm_start(target: Dict[str, torch.Tensor],
                       loaded: Dict[str, torch.Tensor],
                       rename: Optional[Dict[str, str]] = None
                       ) -> Dict[str, torch.Tensor]:
    """``target`` with the entries of ``loaded`` that match by name and
    shape (the reference's filtered load, train.py:191-229); ``rename``
    maps loaded top-level scopes to target ones (e.g.
    ``{"netG": "normal_filter"}``)."""
    merged = dict(target)
    for k, v in loaded.items():
        for src, dst in (rename or {}).items():
            if k.startswith(src + "."):
                k = dst + k[len(src):]
                break
        if k in merged and merged[k].shape == v.shape:
            merged[k] = v
    return merged


def restore(model: torch.nn.Module, optimizer, path: str) -> int:
    """Full resume: the model's parameters and BatchNorm statistics (name
    and shape matches; frozen scopes keep their values), the optimizer's
    state; returns the step."""
    ck = load_checkpoint(path)
    model.load_state_dict(partial_warm_start(model.state_dict(),
                                             ck["state_dict"]))
    if optimizer is not None and "optimizer" in ck:
        dev = next(model.parameters()).device
        opt_sd = ck["optimizer"]
        opt_sd["state"] = {n: {k: v.to(dev) for k, v in st.items()}
                           for n, st in opt_sd["state"].items()}
        optimizer.load_state_dict(opt_sd)
    return int(ck["step"])


class CheckpointManager:
    """Top-k on a monitored metric + always-keep-latest
    (reference ModelCheckpoint(save_top_k=3), train.py:90-98); its
    ``index.json`` survives restarts."""

    def __init__(self, ckpt_dir: str, top_k: int = 3, mode: str = "min"):
        self.dir = os.path.abspath(ckpt_dir)
        self.top_k = top_k
        self.mode = mode
        self.records: List[Tuple[float, str]] = []
        self.latest: Optional[str] = None
        os.makedirs(self.dir, exist_ok=True)
        self._index = os.path.join(self.dir, "index.json")
        if os.path.exists(self._index):
            with open(self._index) as f:
                data = json.load(f)
            self.records = [tuple(r) for r in data.get("records", [])]
            self.latest = data.get("latest")

    def save(self, step: int, model: torch.nn.Module, optimizer,
             metric: float) -> str:
        path = save_checkpoint(self.dir, step, model, optimizer)
        prev_latest = self.latest
        self.latest = path
        self.records = [r for r in self.records if r[1] != path]
        self.records.append((float(metric), path))
        self.records.sort(key=lambda r: r[0] if self.mode == "min"
                          else -r[0])
        keep = {p for _, p in self.records[:self.top_k]} | {self.latest}
        for _, p in self.records[self.top_k:]:
            if p not in keep and os.path.exists(p):
                os.remove(p)
        self.records = self.records[:self.top_k]
        if prev_latest and prev_latest not in keep and \
                os.path.exists(prev_latest):
            os.remove(prev_latest)
        with open(self._index, "w") as f:
            json.dump({"records": self.records, "latest": self.latest}, f)
        return path

    @property
    def best(self) -> Optional[str]:
        return self.records[0][1] if self.records else None
