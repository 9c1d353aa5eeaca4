"""Dual-variable warm start for the OBCA constraints.

Port of ``obca_tpu.warmstart.dual_ws``: per stage pose and obstacle,
lam = onehot(most-separating face) (so ||A'lam|| = 1 exactly) and mu
from the positive/negative parts of w = -R'A'lam (so G'mu = -R'A'lam
exactly), both lifted by an eps floor for a strictly interior start.
"""

from __future__ import annotations

import torch

from obca_torch import nlp
from obca_torch._util import one_hot
from obca_torch.geometry import rotation


def geometric_duals(spec, X, eps: float = 1e-2):
    """Closed-form duals along trajectories X [B, N+1, 4]:
    (lam [B, N+1, M, V], mu [B, N+1, M, 4])."""
    A = spec.obstacles.A                                  # [B, M, V, 2]
    fm = spec.obstacles.face_mask[:, None]                # [B, 1, M, V]
    om = spec.obstacles.obs_mask[:, None, :, None]        # [B, 1, M, 1]
    face_val = (torch.einsum("bmvd,bkd->bkmv", A, X[..., :2])
                - spec.obstacles.b[:, None])
    face_val = torch.where(fm > 0, face_val, torch.full_like(face_val, -1e9))
    i_star = torch.argmax(face_val, dim=-1)               # [B, K, M]
    lam = one_hot(i_star, A.shape[2], X.dtype) * fm
    Atlam = torch.einsum("bmvd,bkmv->bkmd", A, lam)
    R = rotation(X[..., 2])                               # [B, K, 2, 2]
    w = -torch.einsum("bkmd,bkde->bkme", Atlam, R)        # -R'A'lam
    zero = torch.zeros_like(w[..., 0])
    mu = torch.stack([torch.maximum(w[..., 0], zero),
                      torch.maximum(-w[..., 0], zero),
                      torch.maximum(w[..., 1], zero),
                      torch.maximum(-w[..., 1], zero)], dim=-1)
    lam = (lam + eps) * fm * om
    mu = (mu + eps) * om
    return lam, mu


def apply_dual_ws(spec, W, eps: float = 1e-2):
    """Write the geometric dual warm start into trajectories W."""
    L = nlp.layout_of(spec)
    lam, mu = geometric_duals(spec, W[..., L.sl_x], eps)
    B, Np1 = W.shape[0], L.N + 1
    W = W.clone()
    W[..., L.sl_lam] = lam.reshape(B, Np1, -1)
    W[..., L.sl_mu] = mu.reshape(B, Np1, -1)
    return W
