"""The NormalNet's training step (``icon_tpu.training.normal_step``;
reference apps/Normal.py).

The reference steps two Adam optimizers, one per generator, on separate
front and back losses (Normal.py:37-115). Each loss reaches only its own
generator, and Adam works per parameter, so one Adam over both generators
on ``L_F + L_B`` takes the same step; the JAX package and the port take that
form: optax's ``adam`` at ``lr_N`` with the piecewise-constant schedule,
whatever ``cfg.optim`` says (:func:`make_normal_optimizer`).

Loss: ``5 * SmoothL1(pred, gt)`` per side (NormalNet.get_norm_error,
NormalNet.py:101-122). The reference's VGG perceptual term is computed
under ``no_grad``: it adds no gradient, only to the loss *value* that
drives its validation checkpoint selection, so :func:`normal_eval_step`
adds it when VGG19 weights are given.

In a process group of several ranks the gradients are averaged over the
ranks before the update and the metrics are the global batch's (the
NormalNet's instance norm needs no global moments).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from icon_tpu_torch.config import Config
from icon_tpu_torch.models.hgpifu import smooth_l1
from icon_tpu_torch.models.normalnet import NormalNet
from icon_tpu_torch.parallel import dist
from icon_tpu_torch.training.train_step import Optimizer


def make_normal_optimizer(net: NormalNet, cfg: Config,
                          steps_per_epoch: int = 1000) -> Optimizer:
    """optax's ``adam`` over both generators at ``cfg.lr_N``, scaled by
    ``cfg.gamma`` from each ``cfg.schedule`` epoch on; no weight decay."""
    return Optimizer(net.named_parameters(),
                     cfg.replace(optim="Adam", weight_decay=0.0),
                     steps_per_epoch, lr=cfg.lr_N)


def _losses(net: NormalNet, batch: Dict[str, torch.Tensor]):
    nml_f, nml_b = net(batch)
    return (nml_f, nml_b, 5.0 * smooth_l1(nml_f, batch["normal_F"]),
            5.0 * smooth_l1(nml_b, batch["normal_B"]))


def normal_train_step(net: NormalNet, opt: Optimizer,
                      batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """One Adam step on a batch already on the net's device; the metrics
    as 0-d device tensors (no host read)."""
    net.train()
    opt.zero_grad()
    _, _, loss_f, loss_b = _losses(net, batch)
    loss = loss_f + loss_b
    loss.backward()
    dist.all_reduce_mean_grads(net)
    opt.step()
    return _global({"loss": loss.detach(), "loss_F": loss_f.detach(),
                    "loss_B": loss_b.detach()})


def _global(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-rank means of equal slices -> the global batch's, in one
    all-reduce (the metrics themselves without a group)."""
    if dist.world() <= 1:
        return metrics
    mean = dist.all_reduce_sum(torch.stack(list(metrics.values()))) \
        / dist.world()
    return dict(zip(metrics, mean))


@torch.no_grad()
def normal_eval_step(net: NormalNet, batch: Dict[str, torch.Tensor],
                     vgg: Optional[torch.nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Validation losses (reference Normal.py validation_step): per side
    ``5 * SmoothL1``, plus the perceptual value when ``vgg`` is given;
    ``loss`` is their sum (Normal.py:199)."""
    from icon_tpu_torch.models.vgg import vgg_perceptual_loss
    net.eval()
    nml_f, nml_b, loss_f, loss_b = _losses(net, batch)
    metrics = {"loss_F": loss_f, "loss_B": loss_b}
    if vgg is not None:
        loss_f = loss_f + vgg_perceptual_loss(vgg, nml_f, batch["normal_F"])
        loss_b = loss_b + vgg_perceptual_loss(vgg, nml_b, batch["normal_B"])
    metrics["loss"] = loss_f + loss_b
    return _global(metrics)
