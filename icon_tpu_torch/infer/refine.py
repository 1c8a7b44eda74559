"""The two per-image optimization loops of the demo (``icon_tpu.infer.refine``;
reference apps/infer.py).

1. **SMPL fit** (infer.py:123-273, HOT LOOP 1): the body's pose, shape,
   orientation and translation move so that its normal renders match the
   NormalNet's cloth normals and its soft silhouettes the image matte.
   Gradients flow through LBS and the differentiable rasterizer.
2. **Cloth refinement** (infer.py:431-505, HOT LOOP 3): a per-vertex
   LocalAffine deformation of the reconstruction against the predicted
   normals, with Laplacian, edge, normal-consistency, stiffness and
   rigidity priors (mesh_util.py:168-184).

The parameters are explicit tensors and the optimizers plain functions that
reproduce optax's updates (``adam``; ``sgd`` with momentum chained with
``contrib.reduce_on_plateau``). Every loss and the plateau state stay on the
device: an iteration reads nothing to the host, and the loss history is
read once at the end.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from icon_tpu_torch.models.local_affine import (apply_local_affine,
                                                init_local_affine, rigid_loss,
                                                stiffness_loss)
from icon_tpu_torch.models.smplx.body import BodyModel
from icon_tpu_torch.ops.mesh_losses import (edge_face_adjacency,
                                            edge_length_loss, laplacian_loss,
                                            mesh_edges,
                                            normal_consistency_loss)
from icon_tpu_torch.render.render import (render_normal, render_normal_sil,
                                          render_silhouette)

Params = Dict[str, torch.Tensor]


# -- optimizers: optax's updates on dicts of tensors -------------------------

class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adam_step(params: Params, grads: Params, state: AdamState, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
              ) -> AdamState:
    """One ``optax.adam(lr)`` update of ``params`` in place (bias-corrected
    moments, ``eps`` outside the square root)."""
    count = state.count + 1
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for k, g in grads.items():
        mu = (1.0 - b1) * g + b1 * state.mu[k]
        nu = (1.0 - b2) * (g * g) + b2 * state.nu[k]
        state.mu[k], state.nu[k] = mu, nu
        params[k].add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))
    return AdamState(count, state.mu, state.nu)


class PlateauState(NamedTuple):
    trace: Params               # the momentum buffers
    best: torch.Tensor          # 0-d: best loss so far
    plateau: torch.Tensor       # 0-d int: steps without improvement
    scale: torch.Tensor         # 0-d: the learning-rate scale


def sgd_plateau_init(params: Params) -> PlateauState:
    ref = next(iter(params.values()))
    return PlateauState({k: torch.zeros_like(v) for k, v in params.items()},
                        ref.new_tensor(float("inf")),
                        torch.zeros((), dtype=torch.int32,
                                    device=ref.device),
                        ref.new_tensor(1.0))


def plateau_update(state: PlateauState, value: torch.Tensor, factor: float,
                   patience: int, min_scale: float, rtol: float = 1e-4
                   ) -> PlateauState:
    """``optax.contrib.reduce_on_plateau``'s scale for the loss ``value``
    (no cooldown, accumulation 1): an improvement is ``value < (1 - rtol) *
    best``; when the steps without one reach ``patience`` the scale drops
    by ``factor`` (not below ``min_scale``) and the count restarts. Device
    ops only."""
    value = value.detach().to(state.best.dtype)
    improved = value < (1.0 - rtol) * state.best
    best = torch.where(improved, value, state.best)
    plateau = torch.where(improved, torch.zeros_like(state.plateau),
                          state.plateau + 1)
    reduce = plateau == patience
    plateau = torch.where(reduce, torch.zeros_like(plateau), plateau)
    scale = torch.clamp(torch.where(reduce, state.scale * factor,
                                    state.scale), min=min_scale)
    return PlateauState(state.trace, best, plateau, scale)


@torch.no_grad()
def sgd_plateau_step(params: Params, grads: Params, state: PlateauState,
                     value: torch.Tensor, lr: float, momentum: float = 0.9,
                     factor: float = 0.5, patience: int = 5,
                     min_scale: float = 1e-2) -> PlateauState:
    """One update of ``optax.chain(optax.sgd(lr, momentum),
    optax.contrib.reduce_on_plateau(factor, patience, min_scale=...))`` in
    place, ``value`` being the loss at the parameters before the step: the
    trace ``t = g + momentum * t`` times ``-lr``, times this step's scale."""
    state = plateau_update(state, value, factor, patience, min_scale)
    for k, g in grads.items():
        t = g + momentum * state.trace[k]
        state.trace[k] = t
        params[k].add_(state.scale * (-lr * t))
    return state


def _leaf_params(values: Dict[str, np.ndarray], device=None) -> Params:
    """Fresh float32 leaves on ``device`` from numpy arrays."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        device).requires_grad_(True) for k, v in values.items()}


def _grads(loss: torch.Tensor, params: Params) -> Params:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


# -- SMPL fit ----------------------------------------------------------------

def make_smpl_refine_step(body_model: BodyModel, faces: torch.Tensor,
                          goal_normal_F: torch.Tensor,
                          goal_normal_B: torch.Tensor,
                          goal_mask: torch.Tensor, lr: float = 1e-2,
                          size: int = 512,
                          scale: Optional[torch.Tensor] = None,
                          w_normal: float = 1.0, w_sil: float = 1.0):
    """(init, step, forward_verts) of the Adam fit of betas, body pose,
    global orientation (axis-angle) and translation to given normal and
    silhouette targets (infer.py:150-171). ``init(betas, body_pose,
    global_orient, trans)`` -> state; ``step(state)`` -> (state, loss), the
    loss at the parameters before the step."""

    def forward_verts(params):
        verts, _ = body_model(betas=params["betas"],
                              global_orient=params["global_orient"],
                              body_pose=params["body_pose"],
                              transl=params["trans"], scale=scale)
        return verts[0]

    def loss_fn(params):
        verts = forward_verts(params)
        nF, _ = render_normal(verts, faces, size=size, azimuth=0.0)
        nB, _ = render_normal(verts, faces, size=size, azimuth=180.0)
        sil = render_silhouette(verts, faces, size=size, azimuth=0.0)
        # normal L1 on the joint support (the reference's diff masks)
        lossN = torch.mean(torch.abs(nF - goal_normal_F)) + \
            torch.mean(torch.abs(nB - goal_normal_B))
        lossS = torch.mean(torch.abs(sil - goal_mask))
        return w_normal * lossN + w_sil * lossS

    def step(state):
        params, opt = state
        loss = loss_fn(params)
        opt = adam_step(params, _grads(loss, params), opt, lr)
        return (params, opt), loss.detach()

    def init(betas, body_pose, global_orient, trans):
        params = _leaf_params({"betas": betas, "body_pose": body_pose,
                               "global_orient": global_orient,
                               "trans": trans}, device=faces.device)
        return params, adam_init(params)

    return init, step, forward_verts


def refine_smpl(body_model: BodyModel, faces: torch.Tensor,
                init_params: Dict, goal_normal_F: torch.Tensor,
                goal_normal_B: torch.Tensor, goal_mask: torch.Tensor,
                iters: int = 100, lr: float = 1e-2, size: int = 512,
                scale: Optional[torch.Tensor] = None
                ) -> Tuple[Params, torch.Tensor, List[float]]:
    """Run the Adam fit; (refined params, final verts ``[V, 3]``, losses)."""
    init, step, forward_verts = make_smpl_refine_step(
        body_model, faces, goal_normal_F, goal_normal_B, goal_mask, lr=lr,
        size=size, scale=scale)
    state = init(**init_params)
    losses = []
    for _ in range(iters):
        state, loss = step(state)
        losses.append(loss)
    params = {k: v.detach() for k, v in state[0].items()}
    with torch.no_grad():
        verts = forward_verts(params)
    return params, verts, torch.stack(losses).tolist() if losses else []


NormalFn = Callable[[Dict[str, torch.Tensor]],
                    Tuple[torch.Tensor, torch.Tensor]]


class SmplFit(NamedTuple):
    verts: torch.Tensor         # [V, 3] the fitted body in render space
    normals: Tuple[torch.Tensor, torch.Tensor]   # last (normal_F, normal_B)
    losses: List[float]
    params: Params


def refine_smpl_live(body_model: BodyModel, faces: torch.Tensor,
                     image: torch.Tensor, init: Dict, normal_fn: NormalFn,
                     scale: float, mask: torch.Tensor, iters: int = 100,
                     lr: float = 1e-3, size: int = 512, patience: int = 5,
                     w_normal: float = 1.0, w_sil: float = 1.0,
                     raster_k: int = 96) -> SmplFit:
    """The demo's body fit (infer.py:123-273).

    - ``body_pose [1, J-1, 3, 3]`` and ``global_orient [1, 1, 3, 3]`` are
      optimized as raw rotation matrices (``pose2rot=False``, no
      re-orthonormalization), ``trans [3]`` and ``scale`` apply after LBS;
    - each iteration renders the body's normals and soft silhouettes at
      azimuth 0 and 180 once, with gradients; ``normal_fn`` (the NormalNet,
      ``{"image", "T_normal_F", "T_normal_B"}`` -> ``(normal_F,
      normal_B)``, NHWC) predicts the cloth normals from the detached
      renders under ``no_grad``, and they enter the loss as constants (the
      JAX loop renders the same images twice, once for the net and once for
      the loss; the numbers are the same);
    - the loss: L1 of the renders against the predictions (front and back)
      plus half the L1 of both soft silhouettes against the image matte
      ``mask [H, W]`` (the demo's branch; the JAX function can also take
      the predictions' non-zero support);
    - SGD with momentum 0.9 and reduce-on-plateau (factor 0.5,
      ``patience``, min scale 1e-2), fed the loss before each step.

    Returns :class:`SmplFit` (the losses are read to the host once)."""
    dev = faces.device
    params = _leaf_params(init, device=dev)
    opt = sgd_plateau_init(params)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    gt = (mask > 0.5).to(torch.float32)

    def forward_verts(p):
        nb = p["body_pose"].shape[1]
        verts, _ = body_model(betas=p["betas"],
                              global_orient=p["global_orient"].reshape(1, 9),
                              body_pose=p["body_pose"].reshape(1, nb * 9),
                              pose2rot=False)
        return (verts[0] + p["trans"][None]) * scale

    losses = []
    nF = nB = None
    for _ in range(iters):
        verts = forward_verts(params)
        T_nF, _, silF = render_normal_sil(verts, faces, size=size,
                                          azimuth=0.0, K=raster_k)
        T_nB, _, silB = render_normal_sil(verts, faces, size=size,
                                          azimuth=180.0, K=raster_k)
        with torch.no_grad():
            nF, nB = normal_fn({"image": image[None],
                                "T_normal_F": T_nF.detach()[None],
                                "T_normal_B": T_nB.detach()[None]})
            nF, nB = nF[0], nB[0]
        lossN = torch.mean(torch.abs(T_nF - nF)) + \
            torch.mean(torch.abs(T_nB - nB))
        lossS = 0.5 * (torch.mean(torch.abs(silF - gt)) +
                       torch.mean(torch.abs(silB - gt)))
        loss = w_normal * lossN + w_sil * lossS
        opt = sgd_plateau_step(params, _grads(loss, params), opt,
                               loss.detach(), lr, patience=patience)
        losses.append(loss.detach())
    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        verts = forward_verts(params)
    return SmplFit(verts, (nF, nB),
                   torch.stack(losses).tolist() if losses else [], params)


# -- cloth refinement --------------------------------------------------------

def refine_cloth(verts: torch.Tensor, faces: torch.Tensor,
                 goal_normal_F: torch.Tensor, goal_normal_B: torch.Tensor,
                 iters: int = 200, lr: float = 1e-4, size: int = 512,
                 w_cloth: float = 1e1, w_stiff: float = 1e5,
                 w_rigid: float = 1e5, w_lap: float = 1e2,
                 w_edge: float = 0.0, w_nc: float = 1e1
                 ) -> Tuple[torch.Tensor, List[float]]:
    """LocalAffine cloth refinement (infer.py:431-505; the loss weights are
    the reference's anneal targets), Adam. ``verts [V, 3]``, ``faces
    [F, 3]`` int64, goals ``[H, W, 3]``. Returns (refined verts, losses)."""
    faces_np = faces.cpu().numpy()
    edges = torch.as_tensor(mesh_edges(faces_np), dtype=torch.int64,
                            device=faces.device)
    fpairs = torch.as_tensor(edge_face_adjacency(faces_np),
                             dtype=torch.int64, device=faces.device)
    verts0 = verts.detach()

    def loss_fn(params):
        deformed = apply_local_affine(params, verts0)
        nF, _ = render_normal(deformed, faces, size=size, azimuth=0.0)
        nB, _ = render_normal(deformed, faces, size=size, azimuth=180.0)
        l_cloth = torch.mean(torch.abs(nF - goal_normal_F)) + \
            torch.mean(torch.abs(nB - goal_normal_B))
        loss = (w_cloth * l_cloth +
                w_stiff * stiffness_loss(params, edges) +
                w_rigid * rigid_loss(params) +
                w_lap * laplacian_loss(deformed, edges) +
                w_nc * normal_consistency_loss(deformed, faces, fpairs))
        if w_edge:
            loss = loss + w_edge * edge_length_loss(deformed, edges)
        return loss

    params = {k: v.requires_grad_(True) for k, v in
              init_local_affine(verts0.shape[0], device=verts0.device).items()}
    opt = adam_init(params)
    losses = []
    for _ in range(iters):
        loss = loss_fn(params)
        opt = adam_step(params, _grads(loss, params), opt, lr)
        losses.append(loss.detach())
    with torch.no_grad():
        out = apply_local_affine(params, verts0)
    return out, torch.stack(losses).tolist() if losses else []
