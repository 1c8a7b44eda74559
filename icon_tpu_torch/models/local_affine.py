"""Per-vertex local affine deformation of the cloth refinement
(``icon_tpu.models.local_affine``; reference lib/net/local_affine.py, from
pytorch-nicp): each vertex owns a 3x3 matrix ``A_v`` and a translation
``t_v`` and moves to ``A_v v + t_v``. Two regularizers: stiffness
(neighbouring vertices deform alike) and rigidity (``A^T A`` near I). The
parameters are a plain dict of tensors."""

from __future__ import annotations

from typing import Dict

import torch


def init_local_affine(n_verts: int, device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Identity transforms for ``n_verts`` vertices on ``device`` (the card
    unless the caller passes its own)."""
    return {"A": torch.eye(3, device=device)[None].repeat(n_verts, 1, 1),
            "t": torch.zeros((n_verts, 3), device=device)}


def apply_local_affine(params: Dict[str, torch.Tensor],
                       verts: torch.Tensor) -> torch.Tensor:
    """``[V, 3]`` -> ``[V, 3]``."""
    return torch.einsum("vij,vj->vi", params["A"], verts) + params["t"]


def stiffness_loss(params: Dict[str, torch.Tensor],
                   edges: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the whole affine transform across edges
    (local_affine.py:45-53)."""
    A, t = params["A"], params["t"]
    dA = A[edges[:, 0]] - A[edges[:, 1]]
    dt = t[edges[:, 0]] - t[edges[:, 1]]
    return torch.mean(torch.sum(dA ** 2, dim=(1, 2)) + torch.sum(dt ** 2,
                                                                 dim=1))


def rigid_loss(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """||A^T A - I||^2 per vertex (keeps the deformation near rotational)."""
    A = params["A"]
    AtA = torch.einsum("vji,vjk->vik", A, A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)[None]
    return torch.mean(torch.sum((AtA - eye) ** 2, dim=(1, 2)))
