"""Kinematic bicycle dynamics: discretization and rollout.

Port of ``obca_tpu.dynamics``: states x = (X, Y, psi, v), inputs
u = (delta, a), midpoint-velocity Euler with a time scaling tau.
Arguments broadcast elementwise over any leading axes.
"""

from __future__ import annotations

import torch


def step(x, u, tau, Ts, wheelbase):
    """One step x_{k+1} = f(x_k, u_k; tau); x [..., 4], u [..., 2],
    tau / Ts / wheelbase broadcastable to x[..., 0]."""
    X, Y, psi, v = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    delta, a = u[..., 0], u[..., 1]
    h = tau * Ts
    kappa = torch.tan(delta) / wheelbase
    v_mid = v + 0.5 * h * a
    psi_mid = psi + 0.5 * h * v * kappa
    return torch.stack(
        [
            X + h * v_mid * torch.cos(psi_mid),
            Y + h * v_mid * torch.sin(psi_mid),
            psi + h * v_mid * kappa,
            v + h * a,
        ],
        dim=-1,
    )


def rollout(x0, U, tau, Ts, wheelbase):
    """Roll the horizon: x0 [..., 4], U [..., N, 2] -> states
    [..., N+1, 4] (a host loop over the N steps)."""
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(step(xs[-1], U[..., k, :], tau, Ts, wheelbase))
    return torch.stack(xs, dim=-2)


def dynamics_defects(X, U, tau, Ts, wheelbase):
    """Defect residuals x_{k+1} - f(x_k, u_k) [..., N, 4] for X
    [..., N+1, 4], U [..., N, 2]; tau / Ts / wheelbase broadcastable to
    X[..., :-1, 0] (a per-lane scalar as [..., 1])."""
    return X[..., 1:, :] - step(X[..., :-1, :], U, tau, Ts, wheelbase)
