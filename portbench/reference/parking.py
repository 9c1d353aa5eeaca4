"""Plain float64 reference of the OBCA parking problem (kinematic
bicycle, rectangular ego, convex polygon obstacles), written from the
OBCA formulation (Zhang, Liniger, Borrelli, arXiv:1711.03449) and the
configuration file: the same stage variables, constraint rows,
objective and bounds as the problem the program states, in plain
PyTorch on the CPU.

Stage k of a solution W [L, N+1, nw] holds
  w_k = [x (X, Y, psi, v), u (steer, accel), tau, lam (M*V), mu (4M)]
and its rows are
  c_k = [bc (4), dyn (4), tau pin (1), eq (2M), norm (M), dist (M),
         rate (4)],
the layout in which the program hands its outputs over.
"""

from __future__ import annotations

import math

import torch

from .common import F64, halfspaces, polygon_distance, t64

# Columns whose stationarity is checked: the states, inputs and time
# scaling.  The dual columns' objective term is a proximal pull to the
# solver's own anchor, which is not part of the problem.
PRIMAL = slice(0, 7)


def problem(cfg, x0, u_prev=None):
    """The problem data of lanes starting at x0 [L, 4] (float64), with
    previous inputs u_prev [L, 2] (default 0), from configuration
    ``cfg``."""
    x0 = t64(x0)
    L = x0.shape[0]
    M = cfg.get("max_obs") or len(cfg["obstacles"])
    V = cfg.get("max_faces") or max(len(o) for o in cfg["obstacles"])
    A, b, fmask, omask, verts = halfspaces(cfg["obstacles"], M, V)
    return {
        "cfg": cfg, "L": L, "N": int(cfg["N"]), "M": M, "V": V,
        "x0": x0, "xF": t64(cfg["xF"]).expand(L, 4),
        "u_prev": (torch.zeros((L, 2), dtype=F64) if u_prev is None
                   else t64(u_prev)),
        "Ts": float(cfg["Ts"]), "wheelbase": float(cfg["wheelbase"]),
        "ego_g": t64(cfg["ego_g"]), "A": A, "b": b, "fmask": fmask,
        "omask": omask, "verts": verts, "d_min": float(cfg["d_min"]),
        "u_lo": t64(cfg["u_lo"]), "u_hi": t64(cfg["u_hi"]),
        "v_lo": float(cfg["v_lo"]), "v_hi": float(cfg["v_hi"]),
        "xy_lo": t64(cfg["xy_lo"]), "xy_hi": t64(cfg["xy_hi"]),
        "du_max": t64(cfg["du_max"]), "r_u": t64(cfg["r_u"]),
        "r_du": t64(cfg["r_du"]), "q_time": t64(cfg["q_time"]),
        "tau_lo": float(cfg["tau_lo"]), "tau_hi": float(cfg["tau_hi"]),
    }


def step(x, u, h, wheelbase):
    """Kinematic bicycle, midpoint-velocity Euler over time h."""
    X, Y, psi, v = x.unbind(-1)
    delta, a = u.unbind(-1)
    kappa = torch.tan(delta) / wheelbase
    v_mid = v + 0.5 * h * a
    psi_mid = psi + 0.5 * h * v * kappa
    return torch.stack([X + h * v_mid * torch.cos(psi_mid),
                        Y + h * v_mid * torch.sin(psi_mid),
                        psi + h * v_mid * kappa, v + h * a], -1)


def nw(p):
    return 7 + p["M"] * p["V"] + 4 * p["M"]


def nc(p):
    return 13 + 4 * p["M"]


def _unpack(p, W):
    M, V = p["M"], p["V"]
    lead = W.shape[:-1]
    return (W[..., 0:4], W[..., 4:6], W[..., 6],
            W[..., 7:7 + M * V].reshape(lead + (M, V)),
            W[..., 7 + M * V:7 + M * V + 4 * M].reshape(lead + (M, 4)))


def rate_rows(p, u, u_prev):
    du = u - u_prev
    lim = p["du_max"] * p["Ts"]
    return torch.stack([lim[0] - du[..., 0], lim[0] + du[..., 0],
                        lim[1] - du[..., 1], lim[1] + du[..., 1]], -1)


def constraints(p, W):
    """Constraint rows c [L, N+1, nc] of W [L, N+1, nw], every stage's
    full row set (the masks say which rows exist)."""
    N = p["N"]
    x, u, tau, lam, mu = _unpack(p, W)
    k = torch.arange(N + 1)
    first = (k == 0).to(F64)[None, :, None]
    c_bc = x - (first * p["x0"][:, None] + (1.0 - first) * p["xF"][:, None])
    x_next = torch.cat([x[:, 1:], x[:, -1:]], 1)
    c_dyn = x_next - step(x, u, p["Ts"], p["wheelbase"])
    c_tau = tau - 1.0
    # eq = G' mu + R' A' lam;  dist = -g' mu + lam' (A t - b)
    c, s = torch.cos(x[..., 2])[..., None], torch.sin(x[..., 2])[..., None]
    Atlam = torch.einsum("mvd,lkmv->lkmd", p["A"], lam)
    a0, a1 = Atlam[..., 0], Atlam[..., 1]
    eq = torch.stack([mu[..., 0] - mu[..., 1] + a0 * c + a1 * s,
                      mu[..., 2] - mu[..., 3] - a0 * s + a1 * c], -1)
    At = torch.einsum("mvd,lkd->lkmv", p["A"], x[..., :2])
    dist = (-(mu * p["ego_g"]).sum(-1)
            + (lam * (At - p["b"])).sum(-1))
    norm = (Atlam ** 2).sum(-1) - 1.0
    u_before = torch.cat([p["u_prev"][:, None], u[:, :-1]], 1)
    L = W.shape[0]
    return torch.cat([c_bc, c_dyn, c_tau[..., None],
                      eq.reshape(L, N + 1, -1), norm, dist - p["d_min"],
                      rate_rows(p, u, u_before)], -1)


def masks(p):
    """(active [L, N+1, nc], is_eq [nc])."""
    N, M, L = p["N"], p["M"], p["L"]
    act = torch.zeros((L, N + 1, nc(p)), dtype=F64)
    act[:, [0, N], 0:4] = 1.0
    act[:, :N, 4:8] = 1.0
    act[:, :, 8] = 1.0
    om = p["omask"]
    act[:, :, 9:9 + 2 * M] = om.repeat_interleave(2)
    act[:, :, 9 + 2 * M:9 + 3 * M] = om
    act[:, :, 9 + 3 * M:9 + 4 * M] = om
    on = (p["du_max"] >= 0).to(F64)[[0, 0, 1, 1]]
    act[:, :N, 9 + 4 * M:13 + 4 * M] = on
    is_eq = torch.zeros(nc(p), dtype=F64)
    is_eq[:9 + 3 * M] = 1.0
    return act, is_eq


def objective(p, W):
    """Input and input-rate quadratics, the time penalty and the pins on
    padded duals and on the unused last input (the dual columns'
    proximal pull is left out: see PRIMAL)."""
    N, L = p["N"], p["L"]
    x, u, tau, lam, mu = _unpack(p, W)
    du = (u - torch.cat([p["u_prev"][:, None], u[:, :-1]], 1))[:, :N] \
        / p["Ts"]
    q = p["q_time"]
    fm = p["fmask"].reshape(-1)
    om = p["omask"].repeat_interleave(4)
    pin = ((lam.reshape(L, N + 1, -1) ** 2 * (1.0 - fm)).sum()
           + (mu.reshape(L, N + 1, -1) ** 2 * (1.0 - om)).sum()
           + (u[:, N] ** 2).sum())
    return ((u[:, :N] ** 2 * p["r_u"]).sum() + (du ** 2 * p["r_du"]).sum()
            + ((q[0] * tau + q[1] * tau ** 2).sum()) / (N + 1) + 0.5 * pin)


def bounds(p):
    """(lo, hi, has_lo, has_hi), each [L, nw]."""
    L, M, V = p["L"], p["M"], p["V"]
    n = nw(p)
    lo = torch.full((L, n), -1.0, dtype=F64)
    hi = torch.full((L, n), 1.0, dtype=F64)
    has_lo = torch.zeros((L, n), dtype=F64)
    has_hi = torch.zeros((L, n), dtype=F64)
    lo[:, 0:2], hi[:, 0:2] = p["xy_lo"], p["xy_hi"]
    lo[:, 3], hi[:, 3] = p["v_lo"], p["v_hi"]
    lo[:, 4:6], hi[:, 4:6] = p["u_lo"], p["u_hi"]
    lo[:, 6], hi[:, 6] = p["tau_lo"], p["tau_hi"]
    for i in (0, 1, 3, 4, 5, 6):
        has_lo[:, i] = has_hi[:, i] = 1.0
    lo[:, 7:] = 0.0
    has_lo[:, 7:7 + M * V] = p["fmask"].reshape(-1)
    has_lo[:, 7 + M * V:] = p["omask"].repeat_interleave(4)
    return lo, hi, has_lo, has_hi


def ego_polygons(p, X):
    """World corners [..., 4, 2] of the ego at states X [..., >=3]."""
    front, rear, wl, wr = p["ego_g"].tolist()
    body = torch.tensor([[front, wl], [front, -wr], [-rear, -wr],
                         [-rear, wl]], dtype=F64)
    c, s = torch.cos(X[..., 2]), torch.sin(X[..., 2])
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    return body @ R.transpose(-1, -2) + X[..., None, :2]


def clearance_gap(p, X):
    """d_min minus the exact distance of the ego to the nearest real
    obstacle, the largest over the poses X [L, K, >=3]: [L] (above 0:
    too close)."""
    P = ego_polygons(p, t64(X))                        # [L, K, 4, 2]
    real = [m for m in range(p["M"]) if p["omask"][m] > 0]
    d = torch.stack([polygon_distance(P, p["verts"][m].expand(
        P.shape[:-2] + p["verts"][m].shape)) for m in real], -1)
    return p["d_min"] - d.amin(dim=(1, 2))


def warm_start_gap(p, W0, eps):
    """The largest departure of warm starts W0 [L, N+1, nw] from what
    the warm-start stage promises: the first state at the lane's start
    and the last at the goal, inputs and time scaling in their boxes,
    the unused last input 0, and the duals at every stage equal to the
    geometric dual warm start of that stage's own pose (lam one-hot on
    the most separating face, mu the positive and negative parts of
    -R'A'lam, both lifted by ``eps``; where two faces separate equally to
    1e-6, either may be chosen): [L]."""
    W0 = t64(W0)
    x, u, tau, lam, mu = _unpack(p, W0)
    L, K = x.shape[0], x.shape[1]
    gap = torch.maximum((x[:, 0] - p["x0"]).abs().amax(-1),
                        (x[:, -1] - p["xF"]).abs().amax(-1))
    gap = torch.maximum(gap, (tau - 1.0).abs().amax(-1))
    gap = torch.maximum(gap, u[:, -1].abs().amax(-1))
    gap = torch.maximum(gap, torch.relu(u[:, :-1] - p["u_hi"]).amax(
        dim=(1, 2)))
    gap = torch.maximum(gap, torch.relu(p["u_lo"] - u[:, :-1]).amax(
        dim=(1, 2)))
    face = (torch.einsum("mvd,lkd->lkmv", p["A"], x[..., :2]) - p["b"])
    face = torch.where(p["fmask"] > 0, face, torch.full_like(face, -1e9))
    top2 = face.topk(2, dim=-1)
    c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
    best = None
    for j in range(2):
        onehot = torch.nn.functional.one_hot(
            top2.indices[..., j], p["V"]).to(F64) * p["fmask"]
        a = torch.einsum("mvd,lkmv->lkmd", p["A"], onehot)
        # w = -R' A' lam
        w0 = -(a[..., 0] * c[..., None] + a[..., 1] * s[..., None])
        w1 = -(-a[..., 0] * s[..., None] + a[..., 1] * c[..., None])
        mu_ws = torch.stack([torch.relu(w0), torch.relu(-w0), torch.relu(w1),
                             torch.relu(-w1)], -1)
        om = p["omask"][:, None]
        lam_ws = (onehot + eps) * p["fmask"] * om
        mu_ws = (mu_ws + eps) * om
        d = torch.maximum((lam - lam_ws).abs().amax(-1),
                          (mu - mu_ws).abs().amax(-1))          # [L, K, M]
        if j == 1:
            tie = (top2.values[..., 0] - top2.values[..., 1]) <= 1e-6
            d = torch.where(tie, d, torch.full_like(d, math.inf))
            best = torch.minimum(best, d)
        else:
            best = d
    return torch.maximum(gap, best.amax(dim=(1, 2)))


def plant_gap(p, states, controls):
    """The largest |x_{t+1} - f(x_t, u_t)| of closed-loop states
    [L, T+1, 4] under applied controls [L, T, 2] (one control period
    Ts per step, no disturbance): [L]."""
    states, controls = t64(states), t64(controls)
    pred = step(states[:, :-1], controls, p["Ts"], p["wheelbase"])
    return (states[:, 1:] - pred).abs().amax(dim=(1, 2))
