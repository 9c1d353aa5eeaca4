"""Reeds-Shepp shortest car paths — branchless, batched.

Port of ``obca_tpu.warmstart.rs_path``: every candidate word (9 base
words x timeflip/reflect/backwards) is evaluated unconditionally for
every lane, invalid ones and ones whose reconstructed endpoint misses
the goal are masked to +inf, and an argmin picks the winner.

A path is (types [5], lengths [5]): types in {1: left, 0: straight,
2: right, 3: unused}, lengths signed (negative = reverse).
"""

from __future__ import annotations

import numpy as np
import torch

LEFT, STRAIGHT, RIGHT, NONE = 1, 0, 2, 3

_PI = np.pi


def _mod2pi(x):
    """Wrap to (-pi, pi]."""
    return x - 2.0 * _PI * torch.floor((x + _PI) / (2.0 * _PI))


def _polar(x, y):
    return torch.hypot(x, y), torch.atan2(y, x)


# Base words: each returns (valid, t, u, v); total functions (masked, no
# NaNs).  Formulas as in obca_tpu.warmstart.rs_path.


def _LpSpLp(x, y, phi):
    u, t = _polar(x - torch.sin(phi), y - 1.0 + torch.cos(phi))
    v = _mod2pi(phi - t)
    return (t >= 0.0) & (v >= 0.0), t, u, v


def _LpSpRp(x, y, phi):
    u1, t1 = _polar(x + torch.sin(phi), y - 1.0 - torch.cos(phi))
    ok = u1 * u1 >= 4.0
    u = torch.sqrt(torch.clamp(u1 * u1 - 4.0, min=0.0))
    theta = torch.atan2(torch.full_like(u, 2.0), u)
    t = _mod2pi(t1 + theta)
    v = _mod2pi(t - phi)
    return ok & (t >= 0.0) & (v >= 0.0), t, u, v


def _LpRmL(x, y, phi):
    xi = x - torch.sin(phi)
    eta = y - 1.0 + torch.cos(phi)
    u1, theta = _polar(xi, eta)
    ok = u1 <= 4.0
    A = torch.arccos(torch.clamp(u1 / 4.0, -1.0, 1.0))
    t = _mod2pi(theta + _PI / 2.0 + A)
    u = -_mod2pi(_PI - 2.0 * A)
    v = _mod2pi(phi - t + u)
    return ok, t, u, v


def _tau_omega(u, v, xi, eta, phi):
    delta = _mod2pi(u - v)
    A = torch.sin(u) - torch.sin(delta)
    B = torch.cos(u) - torch.cos(delta) - 1.0
    t1 = torch.atan2(eta * A - xi * B, xi * A + eta * B)
    t2 = 2.0 * (torch.cos(delta) - torch.cos(v) - torch.cos(u)) + 3.0
    tau = torch.where(t2 < 0.0, _mod2pi(t1 + _PI), _mod2pi(t1))
    omega = _mod2pi(tau - u + v - phi)
    return tau, omega


def _LpRupLumRm(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho = (2.0 + torch.sqrt(xi * xi + eta * eta)) / 4.0
    ok = (rho >= 0.0) & (rho <= 1.0)
    u = torch.arccos(torch.clamp(rho, -1.0, 1.0))
    t, v = _tau_omega(u, -u, xi, eta, phi)
    return ok & (t >= 0.0) & (v <= 0.0), t, u, v


def _LpRumLumRp(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho = (20.0 - xi * xi - eta * eta) / 16.0
    ok = (rho >= 0.0) & (rho <= 1.0)
    u = -torch.arccos(torch.clamp(rho, -1.0, 1.0))
    t, v = _tau_omega(u, u, xi, eta, phi)
    return ok & (t >= 0.0) & (v >= 0.0), t, u, v


def _LpRmSmLm(x, y, phi):
    xi = x - torch.sin(phi)
    eta = y - 1.0 + torch.cos(phi)
    rho, theta = _polar(xi, eta)
    ok = rho >= 2.0
    r = torch.sqrt(torch.clamp(rho * rho - 4.0, min=0.0))
    u = 2.0 - r
    t = _mod2pi(theta + torch.atan2(r, torch.full_like(r, -2.0)))
    v = _mod2pi(phi - _PI / 2.0 - t)
    return ok & (t >= 0.0) & (u <= 0.0) & (v <= 0.0), t, u, v


def _LpRmSmRm(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho, theta = _polar(-eta, xi)
    ok = rho >= 2.0
    t = theta
    u = 2.0 - rho
    v = _mod2pi(t + _PI / 2.0 - phi)
    return ok & (t >= 0.0) & (u <= 0.0) & (v <= 0.0), t, u, v


def _LpRmSLmRp(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho, _ = _polar(xi, eta)
    ok = rho >= 4.0
    r = torch.sqrt(torch.clamp(rho * rho - 4.0, min=0.0))
    u = 4.0 - r
    t = _mod2pi(torch.atan2((4.0 - u) * xi - 2.0 * eta,
                            -2.0 * xi + (4.0 - u) * eta))
    v = _mod2pi(t - phi)
    return ok & (t >= 0.0) & (u <= 0.0) & (v >= 0.0), t, u, v


_BASES = [_LpSpLp, _LpSpRp, _LpRmL, _LpRupLumRm, _LpRumLumRp, _LpRmSmLm,
          _LpRmSmRm, _LpRmSLmRp]

_L, _S, _R, _N = LEFT, STRAIGHT, RIGHT, NONE


def _flip_lr(types):
    return [({_L: _R, _R: _L}.get(t, t)) for t in types]


def _candidates():
    """(base_fn_index, types [5], signs [5], canonical types, canonical
    signs, timeflip, reflect, backwards) for every candidate word."""
    base = [
        (0, [_L, _S, _L, _N, _N], [1, 1, 1, 0, 0]),
        (1, [_L, _S, _R, _N, _N], [1, 1, 1, 0, 0]),
        (2, [_L, _R, _L, _N, _N], [1, -1, -1, 0, 0]),
        (3, [_L, _R, _L, _R, _N], [1, 1, -1, -1, 0]),
        (4, [_L, _R, _L, _R, _N], [1, -1, -1, 1, 0]),
        (5, [_L, _R, _S, _L, _N], [1, -1, -1, -1, 0]),
        (6, [_L, _R, _S, _R, _N], [1, -1, -1, -1, 0]),
        (7, [_L, _R, _S, _L, _R], [1, -1, -1, -1, 1]),
        (2, [_L, _R, _L, _N, _N], [1, -1, 1, 0, 0]),
    ]
    cands = []
    for fn_idx, types, signs in base:
        for tf in (False, True):
            for rf in (False, True):
                for bw in (False, True):
                    ty = _flip_lr(types) if rf else list(types)
                    ty_canon = list(ty)
                    sg_canon = list(signs)
                    sg = [-s for s in signs] if tf else list(signs)
                    if bw:
                        nseg = sum(1 for t in ty if t != _N)
                        ty = ty[:nseg][::-1] + ty[nseg:]
                        sg = sg[:nseg][::-1] + sg[nseg:]
                    cands.append(
                        (fn_idx, ty, sg, ty_canon, sg_canon, tf, rf, bw))
    return cands


_CANDS = _candidates()
_FN_IDX = np.array([c[0] for c in _CANDS])
_TYPES = np.array([c[1] for c in _CANDS])
_SIGNS = np.array([c[2] for c in _CANDS], dtype=np.float64)
_TYPES_CANON = np.array([c[3] for c in _CANDS])
_SIGNS_CANON = np.array([c[4] for c in _CANDS], dtype=np.float64)
_TF = np.array([c[5] for c in _CANDS])
_RF = np.array([c[6] for c in _CANDS])
_BW = np.array([c[7] for c in _CANDS])


def _advance_pose(pose, seg_type, signed_len, rho):
    """Closed-form pose after driving one segment (broadcasting)."""
    x, y, psi = pose[..., 0], pose[..., 1], pose[..., 2]
    d = signed_len
    one = torch.ones_like(d)
    kappa = torch.where(seg_type == LEFT, one,
                        torch.where(seg_type == RIGHT, -one, 0.0 * one)) / rho
    ksafe = torch.where(torch.abs(kappa) < 1e-12, one, kappa)
    dpsi = d * kappa
    straight = seg_type == STRAIGHT
    nx = torch.where(straight, x + d * torch.cos(psi),
                     x + (torch.sin(psi + dpsi) - torch.sin(psi)) / ksafe)
    ny = torch.where(straight, y + d * torch.sin(psi),
                     y - (torch.cos(psi + dpsi) - torch.cos(psi)) / ksafe)
    return torch.stack([nx, ny, psi + dpsi], dim=-1)


def solve(start, goal, rho):
    """Shortest Reeds-Shepp paths from start [B, 3] = (x, y, psi) to goal
    [B, 3] with turning radius rho [B].  Returns (types [B, 5] int32,
    lengths [B, 5] signed world units, total [B])."""
    dt, dev = start.dtype, start.device
    dx = (goal[:, 0] - start[:, 0]) / rho
    dy = (goal[:, 1] - start[:, 1]) / rho
    c, s = torch.cos(start[:, 2]), torch.sin(start[:, 2])
    x = (c * dx + s * dy)[:, None]
    y = (-s * dx + c * dy)[:, None]
    phi = _mod2pi(goal[:, 2] - start[:, 2])[:, None]

    tf = torch.as_tensor(_TF, device=dev)
    rf = torch.as_tensor(_RF, device=dev)
    bw = torch.as_tensor(_BW, device=dev)
    xb = torch.where(bw, x * torch.cos(phi) + y * torch.sin(phi), x)
    yb = torch.where(bw, x * torch.sin(phi) - y * torch.cos(phi), y)
    xs = torch.where(tf, -xb, xb)
    p2 = torch.where(tf, -phi, phi)
    ys = torch.where(rf, -yb, yb)
    ps = torch.where(rf, -p2, p2)                         # [B, C]

    evals = [f(xs, ys, ps) for f in _BASES]
    fn = torch.as_tensor(_FN_IDX, device=dev)

    def pick(i):
        allb = torch.stack([e[i] for e in evals], dim=-1)  # [B, C, 8]
        return allb.gather(-1, fn.expand(allb.shape[:-1])[..., None])[..., 0]

    valid, t, u, v = pick(0), pick(1), pick(2), pick(3)

    halfpi = torch.full_like(t, _PI / 2.0)
    zero = torch.zeros_like(t)
    raw3 = torch.stack([t, u, v, zero, zero], -1)
    m4cc = torch.stack([t.abs(), u.abs(), u.abs(), v.abs(), zero], -1)
    m4cs = torch.stack([t.abs(), halfpi, u.abs(), v.abs(), zero], -1)
    m5 = torch.stack([t.abs(), halfpi, u.abs(), halfpi, v.abs()], -1)
    is4cc = ((fn == 3) | (fn == 4))[:, None]
    is4cs = ((fn == 5) | (fn == 6))[:, None]
    is5 = (fn == 7)[:, None]
    is3 = ~(is4cc | is4cs | is5)
    ty = torch.as_tensor(_TYPES_CANON, device=dev)
    sg = torch.as_tensor(_SIGNS_CANON, dtype=dt, device=dev)
    is_angle = (ty == _L) | (ty == _R)

    def m2pos(a):
        return a - 2.0 * _PI * torch.floor(a / (2.0 * _PI))

    wrapped = torch.where(sg >= 0, m2pos(raw3), m2pos(-raw3))
    m3 = torch.where(is_angle, wrapped, raw3.abs())
    straight_ok = torch.where(is_angle | (ty == _N),
                              torch.ones_like(valid)[..., None],
                              raw3 * sg >= -1e-12).all(-1)
    mags = torch.where(is5, m5, torch.where(
        is4cc, m4cc, torch.where(is4cs, m4cs, m3)))
    valid = torch.where(is3[:, 0], straight_ok, valid)

    # Backwards words reverse the magnitudes over their active segments.
    n_seg = torch.as_tensor((_TYPES != _N).sum(1), device=dev)
    idx = torch.arange(5, device=dev)
    ridx = torch.where(idx < n_seg[:, None], n_seg[:, None] - 1 - idx, idx)
    mags = torch.where(bw[:, None],
                       mags.gather(-1, ridx.expand(mags.shape)), mags)
    lengths = mags * torch.as_tensor(_SIGNS, dtype=dt, device=dev)

    # Endpoint check in the normalized frame (rho = 1).
    types_arr = torch.as_tensor(_TYPES, device=dev)
    pose = torch.zeros(lengths.shape[:-1] + (3,), dtype=dt, device=dev)
    unit = torch.ones((), dtype=dt, device=dev)
    for i in range(5):
        pose = _advance_pose(pose, types_arr[:, i], lengths[..., i], unit)
    err = (torch.abs(pose[..., 0] - x) + torch.abs(pose[..., 1] - y)
           + torch.abs(_mod2pi(pose[..., 2] - phi)))
    reach = err < 1e-6

    total = torch.sum(mags * (types_arr != _N), dim=-1)
    total = torch.where(valid & reach, total,
                        torch.full_like(total, float("inf")))
    best = torch.argmin(total, dim=-1)
    lane = torch.arange(best.shape[0], device=dev)
    return (types_arr[best].to(torch.int32),
            lengths[lane, best] * rho[:, None],
            total[lane, best] * rho)


def sample(start, rho, types, lengths, ss):
    """Poses and direction along the paths at world arc-lengths ss
    [B, K].  start [B, 3], rho [B], types/lengths [B, 5].  Returns
    (poses [B, K, 3], dirs [B, K] — +1 forward / -1 reverse)."""
    seg_abs = torch.abs(lengths)
    ends = torch.cumsum(seg_abs, dim=-1)
    starts = ends - seg_abs
    rho = rho[:, None]
    starts_pose = [start]
    for i in range(4):
        starts_pose.append(_advance_pose(starts_pose[-1], types[:, i],
                                         lengths[:, i], rho[:, 0]))
    seg_start = torch.stack(starts_pose, dim=1)              # [B, 5, 3]
    seg = torch.searchsorted(ends.contiguous(), ss.contiguous(),
                             right=False).clamp(0, 4)
    g = lambda a: a.gather(1, seg)                           # noqa: E731
    local = torch.minimum(torch.clamp(ss - g(starts), min=0.0), g(seg_abs))
    len_seg = g(lengths)
    signed = local * torch.sign(len_seg)
    p0 = seg_start.gather(1, seg[..., None].expand(seg.shape + (3,)))
    pose = _advance_pose(p0, g(types), signed, rho)
    direction = torch.where(len_seg >= 0.0, torch.ones_like(len_seg),
                            -torch.ones_like(len_seg))
    return pose, direction
