"""The OBCA dual / hyperplane-separation reformulation.

Port of ``obca_tpu.obca``.  For obstacle O_m = {y : A_m y <= b_m} and
ego B = {y : G y <= g} at state x (rotation R(psi), translation t):

    eq      = G' mu_m + R' A_m' lam_m             (= 0)
    dist    = -g' mu_m + lam_m' (A_m t - b_m)     (>= d_min)
    norm_sq = || A_m' lam_m ||^2                  (= 1 signed, <= 1 dist)

and :func:`point_obca_terms`, the point-mass variant of the navigation
family (no ego polytope: no mu, no eq rows).
"""

from __future__ import annotations

import torch


def obca_terms(x, lam, mu, obs_A, obs_b, ego_g):
    """Per-obstacle constraint expressions.

    x [..., 4], lam [..., M, V], mu [..., M, 4]; obs_A [..., M, V, 2],
    obs_b [..., M, V], ego_g [..., 4] broadcast against the leading
    axes of x.  Returns (eq [..., M, 2], dist [..., M], norm_sq [..., M]).
    """
    c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
    t0, t1 = x[..., 0], x[..., 1]
    # A'lam per obstacle [..., M, 2].
    Atlam = torch.einsum("...mvd,...mv->...md", obs_A, lam)
    a0, a1 = Atlam[..., 0], Atlam[..., 1]
    c, s = c[..., None], s[..., None]
    eq = torch.stack(
        [mu[..., 0] - mu[..., 1] + a0 * c + a1 * s,
         mu[..., 2] - mu[..., 3] - a0 * s + a1 * c], dim=-1)
    At = (obs_A[..., 0] * t0[..., None, None]
          + obs_A[..., 1] * t1[..., None, None])              # [..., M, V]
    dist = (-torch.sum(mu * ego_g[..., None, :], dim=-1)
            + torch.sum(lam * (At - obs_b), dim=-1))
    norm_sq = (Atlam ** 2).sum(-1)
    return eq, dist, norm_sq


def dual_distance(x, lam, mu, obs_A, obs_b, ego_g):
    """The dual objective -g'mu + lam'(A t - b) per obstacle [..., M]
    (dist(E(x), O_m) at the optimal feasible duals)."""
    _, dist, _ = obca_terms(x, lam, mu, obs_A, obs_b, ego_g)
    return dist


def point_obca_terms(p, lam, obs_A, obs_b):
    """Point-mass variant (the navigation family): dist(p, O_m) >= d_min
    <=> exists lam_m >= 0 with (A_m p - b_m)' lam_m >= d_min and
    ||A_m' lam_m|| <= 1.

    p [..., 2], lam [..., M, V]; obs_A [..., M, V, 2], obs_b [..., M, V]
    broadcast against the leading axes of p.  Returns (dist [..., M],
    norm_sq [..., M]).
    """
    Ap = (obs_A[..., 0] * p[..., 0, None, None]
          + obs_A[..., 1] * p[..., 1, None, None])           # [..., M, V]
    dist = torch.sum(lam * (Ap - obs_b), dim=-1)
    Atlam = torch.einsum("...mvd,...mv->...md", obs_A, lam)
    return dist, (Atlam ** 2).sum(-1)
