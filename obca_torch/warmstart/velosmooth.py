"""Velocity profile over a coarse path -> time-sampled warm start.

Port of ``obca_tpu.warmstart.velosmooth`` (batched over lanes):
consecutive same-direction segments form runs; the car stops at every
cusp, so each run gets a cosine ease-in/out profile
s(t) = len (1 - cos(pi t / T_r)) / 2 with run durations proportional
to sqrt(run length).  Speeds and positions are clipped into bounds.
"""

from __future__ import annotations

import math

import torch

from obca_torch._util import interp, linspace, one_hot
from obca_torch.warmstart import rs_path


def _run_index(dirs, active):
    """Run index per step: +1 whenever an active step's direction flips
    against the previous active step's (the JAX package's scan, in
    closed form)."""
    P = dirs.shape[-1]
    pos = torch.arange(P, device=dirs.device)
    last = torch.where(active, pos, torch.full_like(pos, -1)).expand_as(
        dirs).cummax(dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]],
                     dim=-1)
    prev_dir = torch.where(prev >= 0, dirs.gather(-1, prev.clamp(min=0)),
                           torch.zeros_like(dirs))
    flip = active & (prev_dir != 0.0) & (dirs * prev_dir < 0.0)
    return torch.cumsum(flip.to(torch.int64), dim=-1)


def _runs(lengths, dirs, active, n_runs, T):
    """Per-run length, direction, start arclength, duration and start
    time ([B, n_runs] each) for steps of unsigned ``lengths``."""
    dt = lengths.dtype
    run_idx = _run_index(dirs, active)
    run_idx = torch.where(active, run_idx,
                          torch.full_like(run_idx, n_runs - 1))
    oh = one_hot(run_idx.clamp(0, n_runs - 1), n_runs, dt)  # [B, P, R]
    act = active.to(dt)
    run_len = torch.einsum("bp,bpr->br", lengths * act, oh)
    run_dir_sum = torch.einsum("bp,bpr->br", lengths * dirs * act, oh)
    run_dir = torch.where(run_len > 1e-9, torch.sign(run_dir_sum),
                          torch.zeros_like(run_len))
    zero = torch.zeros_like(run_len[:, :1])
    run_s0 = torch.cat([zero, torch.cumsum(run_len, -1)[:, :-1]], dim=-1)
    w = torch.sqrt(torch.clamp(run_len, min=0.0))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    T_run = w * T[:, None]
    t0_run = torch.cat([zero, torch.cumsum(T_run, -1)[:, :-1]], dim=-1)
    return run_len, run_dir, run_s0, T_run, t0_run


def _ease(ts, runs, n_runs):
    """Arclength s and signed speed v at times ts [B, K]."""
    run_len, run_dir, run_s0, T_run, t0_run = runs
    started = ((ts[..., None] >= t0_run[:, None, :] - 1e-12)
               & (T_run[:, None, :] > 1e-12))
    ar = torch.arange(n_runs, device=ts.device)
    r = torch.where(started, ar, torch.full_like(ar, -1)).amax(-1).clamp(
        min=0)

    def g(a):
        return a.gather(1, r)

    T_r = torch.clamp(g(T_run), min=1e-12)
    tau = torch.clamp((ts - g(t0_run)) / T_r, 0.0, 1.0)
    ease = 0.5 * (1.0 - torch.cos(math.pi * tau))
    dease = 0.5 * math.pi * torch.sin(math.pi * tau) / T_r
    s = g(run_s0) + g(run_len) * ease
    v = g(run_dir) * g(run_len) * dease
    return s, v


def profile(types, lengths, N, T, dtype=None):
    """Time-sample 5-segment RS paths (types/lengths [B, 5], T [B]):
    (ss [B, N+1] unsigned arclength, vs [B, N+1] signed speed)."""
    dt = dtype or lengths.dtype
    seg_abs = torch.abs(lengths)
    seg_dir = torch.where(lengths >= 0, torch.ones_like(lengths),
                          -torch.ones_like(lengths))
    active = (types != rs_path.NONE) & (seg_abs > 1e-9)
    runs = _runs(seg_abs, seg_dir, active, 5, T)
    ts = linspace(0.0, T, N + 1, dt, lengths.device)
    return _ease(ts, runs, 5)


def polyline_time_sampled(spec, poses, dirs, seg_len, n_runs: int = 8):
    """Time-sample directed pose polylines (lattice plans) into
    (X [B, N+1, 4], U [B, N, 2]).  poses [B, P, 3] (heading unwrapped),
    dirs [B, P] +-1/0, seg_len [B, P] length of the step into poses[i]."""
    dt = poses.dtype
    N = spec.N
    T = N * spec.Ts
    active = seg_len > 1e-9
    runs = _runs(seg_len, dirs, active, n_runs, T)
    cum = torch.cumsum(seg_len, dim=-1)
    ts = linspace(0.0, T, N + 1, dt, poses.device)
    s, vs = _ease(ts, runs, n_runs)
    pose_k = torch.stack([interp(s, cum, poses[..., i]) for i in range(3)],
                         dim=-1)

    margin = 0.02
    vs = torch.clamp(vs, min=(spec.v_lo + margin)[:, None],
                     max=(spec.v_hi - margin)[:, None])
    xy = torch.clamp(pose_k[..., :2], min=(spec.xy_lo + margin)[:, None],
                     max=(spec.xy_hi - margin)[:, None])
    X = torch.cat([xy, pose_k[..., 2:3], vs[..., None]], dim=-1)

    Ts = spec.Ts[:, None]
    dpsi = pose_k[:, 1:, 2] - pose_k[:, :-1, 2]
    ds_signed = vs[:, :-1] * Ts
    big = torch.abs(ds_signed) > 0.05
    kappa = torch.where(big, dpsi / torch.where(big, ds_signed,
                                                torch.ones_like(ds_signed)),
                        torch.zeros_like(dpsi))
    deltas = torch.clamp(torch.arctan(spec.wheelbase[:, None] * kappa),
                         min=(spec.u_lo[:, 0] + margin)[:, None],
                         max=(spec.u_hi[:, 0] - margin)[:, None])
    accels = torch.clamp((vs[:, 1:] - vs[:, :-1]) / Ts,
                         min=(spec.u_lo[:, 1] + margin)[:, None],
                         max=(spec.u_hi[:, 1] - margin)[:, None])
    return X, torch.stack([deltas, accels], dim=-1)


def rs_time_sampled(spec, x0=None, xF=None, delta_frac=0.8):
    """Reeds-Shepp path + smooth velocity profile -> (X [B, N+1, 4],
    U [B, N, 2]); delta_frac sets the RS turning radius as a fraction
    of the steering bound."""
    x0 = spec.x0 if x0 is None else x0
    xF = spec.xF if xF is None else xF
    dt = x0.dtype
    N = spec.N
    rho = spec.wheelbase / torch.tan(delta_frac * spec.u_hi[:, 0])
    types, lengths, _total = rs_path.solve(x0[:, :3], xF[:, :3], rho)
    T = N * spec.Ts
    ss, vs = profile(types, lengths, N, T, dtype=dt)
    poses, _dirs = rs_path.sample(x0[:, :3], rho, types, lengths, ss)

    margin = 0.02
    vs = torch.clamp(vs, min=(spec.v_lo + margin)[:, None],
                     max=(spec.v_hi - margin)[:, None])
    xy = torch.clamp(poses[..., :2], min=(spec.xy_lo + margin)[:, None],
                     max=(spec.xy_hi - margin)[:, None])
    X = torch.cat([xy, poses[..., 2:3], vs[..., None]], dim=-1)

    ends = torch.cumsum(torch.abs(lengths), dim=-1)
    seg = torch.searchsorted(ends.contiguous(), ss[:, :N].contiguous(),
                             right=False).clamp(0, 4)
    ty = types.gather(1, seg)
    one = torch.ones_like(ss[:, :N])
    kappa = torch.where(ty == rs_path.LEFT, one,
                        torch.where(ty == rs_path.RIGHT, -one, 0.0 * one))
    deltas = torch.arctan(spec.wheelbase[:, None] * kappa / rho[:, None])
    accels = torch.clamp((vs[:, 1:] - vs[:, :-1]) / spec.Ts[:, None],
                         min=(spec.u_lo[:, 1] + margin)[:, None],
                         max=(spec.u_hi[:, 1] - margin)[:, None])
    return X, torch.stack([deltas, accels], dim=-1)
