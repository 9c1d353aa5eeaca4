"""Plain float64 reference of the point-mass navigation problem (a
double integrator among convex polygon obstacles, the distance variant
of the dual reformulation with lam-only duals; arXiv:1711.03449's
quadcopter example in the plane), written from its definition and the
configuration file, in plain PyTorch on the CPU.

Stage k of a solution W [L, N+1, nw] holds
  w_k = [p (2), v (2), u (2), tau, lam (M*V)]
and its rows are
  c_k = [bc (4), dyn (4), tau pin (1), norm (M), dist (M), rate (4)],
the layout in which the program hands its outputs over.
"""

from __future__ import annotations

import torch

from .common import F64, halfspaces, point_polygon_distance, t64

PRIMAL = slice(0, 7)


def problem(cfg, x0, u_prev=None):
    """The problem data of lanes starting at x0 [L, 4] from
    configuration ``cfg``."""
    x0 = t64(x0)
    L = x0.shape[0]
    M, V = int(cfg["max_obs"]), int(cfg["max_faces"])
    A, b, fmask, omask, verts = halfspaces(cfg["obstacles"], M, V)
    return {
        "cfg": cfg, "L": L, "N": int(cfg["N"]), "M": M, "V": V,
        "x0": x0, "xF": t64(cfg["xF"]).expand(L, 4),
        "u_prev": (torch.zeros((L, 2), dtype=F64) if u_prev is None
                   else t64(u_prev)),
        "Ts": float(cfg["Ts"]), "A": A, "b": b, "fmask": fmask,
        "omask": omask, "verts": verts, "d_min": float(cfg["d_min"]),
        "u_lo": t64(cfg["u_lo"]), "u_hi": t64(cfg["u_hi"]),
        "v_lo": t64(cfg["v_lo"]), "v_hi": t64(cfg["v_hi"]),
        "xy_lo": t64(cfg["xy_lo"]), "xy_hi": t64(cfg["xy_hi"]),
        "du_max": t64(cfg["du_max"]), "r_u": t64(cfg["r_u"]),
        "r_du": t64(cfg["r_du"]), "q_time": t64(cfg["q_time"]),
        "tau_lo": float(cfg["tau_lo"]), "tau_hi": float(cfg["tau_hi"]),
    }


def step(x, u, h):
    """Double integrator, midpoint Euler over time h."""
    pos, vel = x[..., :2], x[..., 2:]
    return torch.cat([pos + h * (vel + 0.5 * h * u), vel + h * u], -1)


def nw(p):
    return 7 + p["M"] * p["V"]


def nc(p):
    return 13 + 2 * p["M"]


def _unpack(p, W):
    lead = W.shape[:-1]
    return (W[..., 0:4], W[..., 4:6], W[..., 6],
            W[..., 7:7 + p["M"] * p["V"]].reshape(lead + (p["M"], p["V"])))


def constraints(p, W):
    """Constraint rows c [L, N+1, nc] of W [L, N+1, nw]."""
    N = p["N"]
    x, u, tau, lam = _unpack(p, W)
    first = (torch.arange(N + 1) == 0).to(F64)[None, :, None]
    c_bc = x - (first * p["x0"][:, None] + (1.0 - first) * p["xF"][:, None])
    x_next = torch.cat([x[:, 1:], x[:, -1:]], 1)
    c_dyn = x_next - step(x, u, p["Ts"])
    c_tau = tau - 1.0
    Ap = torch.einsum("mvd,lkd->lkmv", p["A"], x[..., :2])
    dist = (lam * (Ap - p["b"])).sum(-1)
    Atlam = torch.einsum("mvd,lkmv->lkmd", p["A"], lam)
    norm = 1.0 - (Atlam ** 2).sum(-1)
    du = u - torch.cat([p["u_prev"][:, None], u[:, :-1]], 1)
    lim = p["du_max"] * p["Ts"]
    rate = torch.stack([lim[0] - du[..., 0], lim[0] + du[..., 0],
                        lim[1] - du[..., 1], lim[1] + du[..., 1]], -1)
    return torch.cat([c_bc, c_dyn, c_tau[..., None], norm,
                      dist - p["d_min"], rate], -1)


def masks(p):
    """(active [L, N+1, nc], is_eq [nc]); norm, dist and rate rows are
    inequalities."""
    N, M, L = p["N"], p["M"], p["L"]
    act = torch.zeros((L, N + 1, nc(p)), dtype=F64)
    act[:, [0, N], 0:4] = 1.0
    act[:, :N, 4:8] = 1.0
    act[:, :, 8] = 1.0
    act[:, :, 9:9 + M] = p["omask"]
    act[:, :, 9 + M:9 + 2 * M] = p["omask"]
    on = (p["du_max"] >= 0).to(F64)[[0, 0, 1, 1]]
    act[:, :N, 9 + 2 * M:] = on
    is_eq = torch.zeros(nc(p), dtype=F64)
    is_eq[:9] = 1.0
    return act, is_eq


def objective(p, W):
    """Input and input-rate quadratics, the time penalty and the pins on
    padded duals and on the unused last input (the dual columns'
    proximal pull is left out: see PRIMAL)."""
    N, L = p["N"], p["L"]
    x, u, tau, lam = _unpack(p, W)
    du = (u - torch.cat([p["u_prev"][:, None], u[:, :-1]], 1))[:, :N] \
        / p["Ts"]
    q = p["q_time"]
    fm = p["fmask"].reshape(-1)
    pin = ((lam.reshape(L, N + 1, -1) ** 2 * (1.0 - fm)).sum()
           + (u[:, N] ** 2).sum())
    return ((u[:, :N] ** 2 * p["r_u"]).sum() + (du ** 2 * p["r_du"]).sum()
            + ((q[0] * tau + q[1] * tau ** 2).sum()) / (N + 1) + 0.5 * pin)


def bounds(p):
    """(lo, hi, has_lo, has_hi), each [L, nw]."""
    L = p["L"]
    n = nw(p)
    lo = torch.full((L, n), -1.0, dtype=F64)
    hi = torch.full((L, n), 1.0, dtype=F64)
    has_lo = torch.zeros((L, n), dtype=F64)
    has_hi = torch.zeros((L, n), dtype=F64)
    lo[:, 0:2], hi[:, 0:2] = p["xy_lo"], p["xy_hi"]
    lo[:, 2:4], hi[:, 2:4] = p["v_lo"], p["v_hi"]
    lo[:, 4:6], hi[:, 4:6] = p["u_lo"], p["u_hi"]
    lo[:, 6], hi[:, 6] = p["tau_lo"], p["tau_hi"]
    has_lo[:, :7] = has_hi[:, :7] = 1.0
    lo[:, 7:] = 0.0
    has_lo[:, 7:] = p["fmask"].reshape(-1)
    return lo, hi, has_lo, has_hi


def clearance_gap(p, X):
    """d_min minus the exact distance of the point to the nearest real
    obstacle, the largest over the states X [L, K, >=2]: [L]."""
    X = t64(X)
    real = [m for m in range(p["M"]) if p["omask"][m] > 0]
    d = torch.stack([point_polygon_distance(
        X[..., :2], p["verts"][m, :int(p["fmask"][m].sum())].expand(
            X.shape[:-1] + (int(p["fmask"][m].sum()), 2)))
        for m in real], -1)
    return p["d_min"] - d.amin(dim=(1, 2))


def warm_start_gap(p, W0, eps):
    """The largest departure of default initial points W0 [L, N+1, nw]
    from their definition: positions on the straight line from the
    lane's start to the goal at equal steps, velocities the forward
    differences over Ts (the last repeated), no inputs, time scaling 1,
    and lam 0.9 one-hot on the most separating face of each real
    obstacle plus ``eps`` (either face where two tie to 1e-6): [L]."""
    W0 = t64(W0)
    x, u, tau, lam = _unpack(p, W0)
    N = p["N"]
    a = torch.linspace(0.0, 1.0, N + 1, dtype=F64)[:, None]
    P = (1.0 - a) * p["x0"][:, None, :2] + a * p["xF"][:, None, :2]
    Vel = torch.diff(P, dim=1) / p["Ts"]
    Vel = torch.cat([Vel, Vel[:, -1:]], 1)
    gap = (x - torch.cat([P, Vel], -1)).abs().amax(dim=(1, 2))
    gap = torch.maximum(gap, u.abs().amax(dim=(1, 2)))
    gap = torch.maximum(gap, (tau - 1.0).abs().amax(-1))
    face = torch.einsum("mvd,lkd->lkmv", p["A"], P) - p["b"]
    face = torch.where(p["fmask"] > 0, face, torch.full_like(face, -1e9))
    top2 = face.topk(2, dim=-1)
    om = p["omask"][:, None]
    best = None
    for j in range(2):
        onehot = torch.nn.functional.one_hot(
            top2.indices[..., j], p["V"]).to(F64) * p["fmask"]
        lam_ws = (0.9 * onehot + eps) * p["fmask"] * om
        d = (lam - lam_ws).abs().amax(-1)
        if j == 1:
            tie = (top2.values[..., 0] - top2.values[..., 1]) <= 1e-6
            best = torch.minimum(best, torch.where(
                tie, d, torch.full_like(d, float("inf"))))
        else:
            best = d
    return torch.maximum(gap, best.amax(dim=(1, 2)))
