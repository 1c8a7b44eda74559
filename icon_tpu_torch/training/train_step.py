"""The geometry network's training step (``icon_tpu.training.train_step``;
reference apps/ICON.py:127-236).

:class:`Optimizer` writes out the JAX package's optax chain update for
update, so that both packages take the same step from the same state:

- ``add_decayed_weights(weight_decay)`` first, when the config has one;
- RMSprop as optax's ``rmsprop``: ``nu = 0.9 nu + 0.1 g^2``, the step
  ``g / sqrt(nu + 1e-8)`` (eps inside the root), scaled by the learning
  rate, then the momentum ``trace`` (``t = u + momentum t``) after the
  scale — torch's ``RMSprop`` differs in all three (alpha 0.99, eps
  outside the root, momentum before the rate);
- Adam as optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the root,
  moments bias-corrected by ``1 - b ** count`` in float32), and SGD as
  optax's ``sgd`` (trace, then rate);
- the rate is optax's ``piecewise_constant_schedule``: ``lr_G`` scaled by
  ``gamma`` from each boundary ``int(e) * steps_per_epoch`` of
  ``cfg.schedule`` on.

Parameters without a gradient in a step are left alone, as torch's
optimizers leave them.

In a process group of several ranks (``parallel/dist.py``) each rank steps
on its slice of the global batch: the gradients are averaged over the
ranks in one all-reduce before the update (BatchNorm already took the
global moments), so every rank takes the global batch's step, and the
metrics are reduced over the ranks, so each rank reports the global
batch's loss, accuracy and IoU, as the JAX step's ``jit`` over the global
array does.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from icon_tpu_torch.config import Config
from icon_tpu_torch.parallel import dist

EPS = 1e-8
RMS_DECAY = 0.9
ADAM_B1, ADAM_B2 = 0.9, 0.999


class Optimizer:
    """optax's ``rmsprop``/``adam``/``sgd`` with the piecewise-constant
    schedule, over named parameters (``model.named_parameters()``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: Config, steps_per_epoch: int = 1000,
                 lr: Optional[float] = None):
        self.params = dict(named_params)
        self.kind = cfg.optim.lower()
        if self.kind not in ("rmsprop", "adam"):
            self.kind = "sgd"
        self.momentum = cfg.momentum or 0.0
        self.weight_decay = cfg.weight_decay
        self.base_lr = lr if lr is not None else cfg.lr_G
        self.boundaries = sorted({int(e) * steps_per_epoch: cfg.gamma
                                  for e in cfg.schedule}.items())
        self.count = 0              # the schedule's step count
        self.adam_count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            n: self._init(p) for n, p in self.params.items()}

    def _init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        names = {"rmsprop": ("nu", "trace"), "adam": ("mu", "nu"),
                 "sgd": ("trace",)}[self.kind]
        return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                for k in names}

    def lr(self, count: Optional[int] = None) -> float:
        count = self.count if count is None else count
        v = self.base_lr
        for boundary, scale in self.boundaries:
            if count >= boundary:
                v = v * scale
        return v

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = self.lr()
        self.adam_count += self.kind == "adam"
        # Adam's bias corrections in float32, as optax computes them
        bias_mu, bias_nu = (1.0 - torch.tensor(b).pow(self.adam_count)
                            for b in (ADAM_B1, ADAM_B2))
        for name, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            if self.weight_decay:
                g = g + self.weight_decay * p
            st = self.state[name]
            if self.kind == "rmsprop":
                st["nu"].copy_((1.0 - RMS_DECAY) * (g * g)
                               + RMS_DECAY * st["nu"])
                u = -lr * (torch.rsqrt(st["nu"] + EPS) * g)
                st["trace"].copy_(u + self.momentum * st["trace"])
                u = st["trace"]
            elif self.kind == "adam":
                st["mu"].copy_((1.0 - ADAM_B1) * g + ADAM_B1 * st["mu"])
                st["nu"].copy_((1.0 - ADAM_B2) * (g * g)
                               + ADAM_B2 * st["nu"])
                mu_hat = st["mu"] / bias_mu
                nu_hat = st["nu"] / bias_nu
                u = -lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
            else:
                st["trace"].copy_(g + self.momentum * st["trace"])
                u = -lr * st["trace"]
            p.add_(u)
        self.count += 1

    def state_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count,
                "adam_count": self.adam_count,
                "state": {n: dict(s) for n, s in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if sd["kind"] != self.kind:
            raise ValueError(f"optimizer state of {sd['kind']}, this one "
                             f"is {self.kind}")
        self.count = int(sd["count"])
        self.adam_count = int(sd["adam_count"])
        for name, st in sd["state"].items():
            for k, v in st.items():
                self.state[name][k].copy_(v)


def make_optimizer(model: torch.nn.Module, cfg: Config,
                   steps_per_epoch: int = 1000,
                   lr: Optional[float] = None) -> Optimizer:
    """RMSprop/Adam/SGD + piecewise lr decay at ``cfg.schedule`` epochs."""
    return Optimizer(model.named_parameters(), cfg, steps_per_epoch, lr)


def batch_to(batch: Dict, device) -> Dict:
    """The tensors of a collated batch on ``device`` (lists stay)."""
    return {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}


def train_step(model: torch.nn.Module, opt: Optimizer,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch already on the model's device (a
    rank's slice in a process group); the global batch's metrics as 0-d
    device tensors (no host read)."""
    model.train()
    opt.zero_grad()
    pred, loss = model(batch)
    loss.backward()
    dist.all_reduce_mean_grads(model)
    opt.step()
    return _metrics(loss.detach(), pred.detach(), batch)


def _metrics(loss: torch.Tensor, pred: torch.Tensor,
             batch) -> Dict[str, torch.Tensor]:
    """The loss, and the occupancy accuracy and IoU at 0.5 (reference
    Evaluator.calc_acc, lib/dataset/Evaluator.py:232-263), of the global
    batch: the ranks' losses averaged and their counts summed in one
    all-reduce."""
    if "label" not in batch:
        return {"loss": dist.all_reduce_sum(loss) / dist.world()}
    hard = (pred > 0.5).to(torch.float32)
    lab = (batch["label"] > 0.5).to(torch.float32)
    sums = torch.stack([loss.to(torch.float32), torch.sum(hard * lab),
                        torch.sum(torch.maximum(hard, lab)),
                        torch.sum((hard == lab).to(torch.float32)),
                        hard.new_tensor(float(hard.numel()))])
    sums = dist.all_reduce_sum(sums)
    return {"loss": sums[0] / dist.world(), "acc": sums[3] / sums[4],
            "iou": sums[1] / torch.clamp(sums[2], min=1.0)}


@torch.no_grad()
def eval_step(model: torch.nn.Module,
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Validation loss and accuracy of the global batch without an update
    (reference validation_step, apps/ICON.py:238-283)."""
    model.eval()
    pred, err = model(batch)
    return _metrics(err, pred, batch)
