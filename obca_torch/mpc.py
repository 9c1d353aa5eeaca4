"""Receding-horizon MPC driver (10 Hz replanning).

Port of ``obca_tpu.mpc``.  At each control period the OCP is re-solved
from the measured state, warm-started by *shifting* the previous
solution one stage (primal and dual), and the first control is applied.
On solver failure the loop degrades statelessly: the stale plan's
control for the current period is applied, and the stale plan keeps
being shifted so it stays time-aligned.

Where the JAX package runs one rollout as a ``lax.scan`` and a fleet as
its ``vmap``, the port runs every rollout in one batched closed loop: a
host loop over the control periods, each period one batched
``ipm.solve_batch`` over all lanes, each lane with its own measured
state, previous control and warm dual state.  Lanes freeze
independently inside the batched solve, as they do under ``vmap``, so the per-lane results are the same; a period's
solve runs until its slowest lane converges or reaches the cap.  Plans
are batch-major: W [B, N+1, nw], duals [B, N+1, nc].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from obca_torch import dynamics, nlp, trace
from obca_torch import spec as spec_mod
from obca_torch.solver import ipm


class MpcResult(NamedTuple):
    states: torch.Tensor     # [B, T+1, 4] closed-loop states
    controls: torch.Tensor   # [B, T, 2] applied controls
    status: torch.Tensor     # [B, T] solver status per step
    iters: torch.Tensor      # [B, T]
    err: torch.Tensor        # [B, T]
    status0: torch.Tensor    # [B] initial full-barrier plan status
    iters0: torch.Tensor     # [B] initial plan iterations


def shift_plan(W, L):
    """Shift trajectories W [B, N+1, nw] one stage for the next solve's
    warm start: stage k <- k+1, last stage duplicated.  The duplicated
    tail keeps the dummy u = 0 control: the plan ends parked (v = 0 at
    the goal), and f(goal, 0) = goal, so the new stage N-1 dynamics row
    is satisfied exactly."""
    return torch.cat([W[:, 1:], W[:, -1:]], dim=1)


def _shift_rows(a):
    """new[k] = old[k+1] for generic stages; new N-1 duplicates old N-1
    (generic mask); the terminal stage keeps old N.  Along axis 1."""
    return torch.cat([a[:, 1:-1], a[:, -2:-1], a[:, -1:]], dim=1)


def shift_dual_state(d: ipm.DualState, L) -> ipm.DualState:
    """Mask-aware stage shift of the full dual state [B, N+1, ...].

    Stages 0..N-1 share the generic constraint mask; stages 0 and N also
    carry boundary-condition equality rows, and stage N's control / rate
    rows are pinned (slack 1, duals 0).  A whole-row shift breaks at
    both mask boundaries: stage N's pinned rate rows would land on the
    active stage N-1 (slack 1 against a small rate bound, a large primal
    residual), and the new stage 0 would take old stage 1's masked
    (zero) boundary-condition multipliers (a dual-stationarity residual
    on the heading column).  So generic rows shift, the stage-0
    boundary-condition multipliers stay (the anchored state moves one
    step; its multiplier varies smoothly), and the duplicated tail stage
    keeps old stage N-1's generic-row multipliers: with the kept
    terminal boundary-condition multiplier this preserves the x_N
    stationarity sum exactly."""
    nu = _shift_rows(d.nu)
    nu[:, 0, L.r_bc] = d.nu[:, 0, L.r_bc]
    return ipm.DualState(nu=nu, s=_shift_rows(d.s), zL=_shift_rows(d.zL),
                         zU=_shift_rows(d.zU))


def _f32(v, like):
    """``v`` rounded through float32, in ``like``'s dtype (the JAX
    package builds the re-solve knobs as float32 scalars)."""
    return torch.tensor(v, dtype=torch.float32).to(like.dtype)


def resolve_config(cfg, resolve_mu=1e-4, resolve_max_iter=60,
                   resolve_tol=None, resolve_delta_w=1e-4):
    """The warm re-solve configuration: barrier start ``resolve_mu``,
    cap ``resolve_max_iter``, strict steps (a step must pass the merit,
    watchdog or SOC test), primal regularization starting at
    ``resolve_delta_w`` and, if given, tolerance ``resolve_tol``."""
    cfg_warm = dataclasses.replace(
        cfg, mu_init=_f32(resolve_mu, cfg.mu_init),
        max_iter=resolve_max_iter, strict_steps=True,
        delta_w=_f32(resolve_delta_w, cfg.delta_w))
    if resolve_tol is not None:
        cfg_warm = dataclasses.replace(cfg_warm,
                                       tol=_f32(resolve_tol, cfg.tol))
    return cfg_warm


def _select(ok, new, old):
    """Per lane: ``new`` where ``ok`` [B], else ``old`` (tensors
    [B, ...] or DualStates)."""
    def pick(a, b):
        return torch.where(ok.reshape(ok.shape + (1,) * (a.dim() - 1)),
                           a, b)

    if isinstance(new, torch.Tensor):
        return pick(new, old)
    return spec_mod.with_leaves(new, [
        pick(a, b) for a, b in zip(spec_mod.tensor_leaves(new),
                                   spec_mod.tensor_leaves(old))])


def _closed_loop(specs, cfg, n_steps, W0, res0, disturbance, cfg_warm):
    """The batched closed loop from the initial plans ``res0``."""
    L = nlp.layout_of(specs)
    dt = cfg.dtype
    B = specs.x0.shape[0]
    W0 = W0.to(dt)
    if disturbance is None:
        disturbance = torch.zeros((B, n_steps, 4), dtype=dt,
                                  device=W0.device)
    disturbance = disturbance.to(device=W0.device, dtype=dt)
    # A failed initial plan starts from W0 with the solver's cold duals:
    # a failed solve's duals beside W0 are no consistent pair.
    ok0 = res0.status == ipm.STATUS_CONVERGED
    W_plan = _select(ok0, res0.W.to(dt), W0)
    duals = _select(ok0, spec_mod.cast_floats(res0.duals, dt),
                    ipm.cold_dual_state(specs, cfg, W0))

    x = specs.x0.to(dt)
    u_prev = specs.u_prev.to(dt)
    xs, us, status, iters, errs = [x], [], [], [], []
    for t in range(n_steps):
        with trace.span("mpc.period"):
            # The stage-0 rate rows reference the control applied in the
            # previous period.
            spec_t = dataclasses.replace(
                specs, x0=x.to(specs.x0.dtype),
                u_prev=u_prev.to(specs.u_prev.dtype))
            # Re-anchor the shifted warm start's first state at the
            # measured state.
            W_ws = W_plan.clone()
            W_ws[:, 0, L.sl_x] = x
            res = ipm.solve_batch(spec_t, cfg_warm, W_ws, duals0=duals)
            ok = res.status == ipm.STATUS_CONVERGED
            # Failure fallback: the stale plan's control for this period.
            u0 = torch.where(ok[:, None], res.U[:, 0], W_plan[:, 0, L.sl_u])
            x = dynamics.step(x, u0, res.tau, specs.Ts,
                              specs.wheelbase) + disturbance[:, t]
            # Shift whichever plan was executed.
            W_plan = shift_plan(_select(ok, res.W, W_plan), L)
            duals = shift_dual_state(_select(ok, res.duals, duals), L)
            u_prev = u0
            xs.append(x)
            us.append(u0)
            status.append(res.status)
            iters.append(res.iters)
            errs.append(res.err)
    return MpcResult(
        states=torch.stack(xs, dim=1), controls=torch.stack(us, dim=1),
        status=torch.stack(status, dim=1), iters=torch.stack(iters, dim=1),
        err=torch.stack(errs, dim=1), status0=res0.status,
        iters0=res0.iters)


def run(spec, cfg, n_steps: int, W0=None, duals0=None, disturbance=None,
        resolve_mu: float = 1e-4, resolve_max_iter: int = 60,
        resolve_tol: float | None = None, resolve_delta_w: float = 1e-4,
        res0: ipm.SolveResult | None = None) -> MpcResult:
    """Closed-loop MPC of one vehicle (unbatched spec) from spec.x0 for
    ``n_steps`` control periods; the result carries no batch axis.

    The initial plan solves with the caller's full barrier schedule from
    W0 [N+1, nw] (default: the lattice warm start) and ``duals0``, or is
    taken from ``res0`` (unbatched); every later re-solve starts from
    the shifted previous solution (primal and duals) under
    :func:`resolve_config`.  If the initial plan fails, the loop starts
    from W0 with the solver's cold duals; its status is ``status0``.
    ``disturbance``: optional [n_steps, 4] additive state perturbations
    applied after each plant step.
    """
    if W0 is None:
        from obca_torch.warmstart import geometric

        W0 = geometric.lattice_warm_start(spec)
    W0 = W0.to(cfg.dtype)
    if res0 is None:
        with trace.span("mpc.plan"):
            res0 = ipm.solve_single(spec, cfg, W0, duals0=duals0)
    out = _closed_loop(
        spec_mod.stack([spec]), cfg, n_steps, W0[None],
        ipm.SolveResult(*[spec_mod.map_tensors(lambda t: t[None], f)
                          for f in res0]),
        None if disturbance is None else disturbance[None],
        resolve_config(cfg, resolve_mu, resolve_max_iter, resolve_tol,
                       resolve_delta_w))
    return MpcResult(*[f[0] for f in out])


def run_fleet(specs, cfg, n_steps: int, W0, disturbance=None,
              resolve_mu: float = 1e-4, resolve_max_iter: int = 60,
              resolve_tol: float | None = None) -> MpcResult:
    """Fleet MPC: batched initial plans through
    ``ipm.solve_batch_rescued`` (a lane whose warm start lands in a bad
    dual basin gets the neighbour-seeded second chance before its loop
    starts), then the batched closed loop.  W0 [B, N+1, nw] stacked warm
    starts; ``disturbance`` [B, n_steps, 4]; the results are [B, T] and
    the states [B, T+1, 4]."""
    with trace.span("mpc.plan"):
        res0 = ipm.solve_batch_rescued(specs, cfg, W0)
    return _closed_loop(specs, cfg, n_steps, W0, res0, disturbance,
                        resolve_config(cfg, resolve_mu, resolve_max_iter,
                                       resolve_tol))
