"""Batched primal-dual interior-point solver for the OBCA NLP.

Port of ``obca_tpu.solver.ipm``: an Ipopt-shaped monotone-barrier
primal-dual IPM (log barrier on bounds and inequality slacks,
fraction-to-boundary, merit line search, SOC, watchdog, adaptive
primal regularization, NaN guard) over a batch of B independent
instances.

Where the JAX package runs one instance under ``vmap`` and a
``lax.while_loop``, the port holds the batch explicitly: every state
field carries a leading B, each iteration computes all lanes, and a
lane whose own predicate ``~converged & iters < max_iter`` was false
before the iteration keeps its state (exactly what ``while_loop`` does
under ``vmap``).  The loop runs while any lane runs.

On a CUDA batch the loop replays CUDA graphs from its second turn on:
the iteration's work up to each factorization is one graph, captured
once per solve, and ``factor_se`` runs eagerly between two graphs, one
call of its wrapper per factorization as on the CPU (:class:`_TurnGraphs`).
The arithmetic is the same either way.

Each phase of an iteration runs under a span of ``obca_torch.trace``
named after the JAX package's scope (``ipm.residuals``, ``ipm.assemble``,
``ipm.ruiz``, ``ipm.recover_ftb``, ``ipm.merit_ls``, ``ipm.soc``,
``ipm.watchdog``, ``ipm.update``), inside ``ipm.iter`` and
``ipm.solve``; ``ipm.sync`` marks each host read of a device value.  A
replayed turn holds ``ipm.replay`` (one a graph) and ``kkt.factor``
instead: the phase spans come from eager turns and from the capture
(``ipm.capture``).

Status codes: 0 = converged, 1 = running/max-iter, 2 = NaN-guarded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from obca_torch import nlp, trace
from obca_torch import spec as spec_mod
from obca_torch.solver import blocktri, kkt
from obca_torch.solver.kernels import blocktri_se as bk
from obca_torch.solver.kernels import runtime

STATUS_CONVERGED = 0
STATUS_RUNNING = 1
STATUS_NAN = 2


class IpmState(NamedTuple):
    W: torch.Tensor         # [B, N+1, nw]
    nu: torch.Tensor        # [B, N+1, nc] (inequality rows: -y)
    s: torch.Tensor         # [B, N+1, nc] slacks (1 on non-ineq rows)
    zL: torch.Tensor        # [B, N+1, nw]
    zU: torch.Tensor        # [B, N+1, nw]
    mu: torch.Tensor        # [B] barrier parameter
    delta_w: torch.Tensor   # [B] adaptive primal regularization
    converged: torch.Tensor  # [B] bool
    nan_fail: torch.Tensor   # [B] bool
    iters: torch.Tensor      # [B] int32
    err: torch.Tensor        # [B] scaled KKT error (mu = 0)


@dataclasses.dataclass(frozen=True)
class DualState:
    """Full inequality/bound dual state for warm re-solves."""

    nu: torch.Tensor   # [B, N+1, nc]
    s: torch.Tensor    # [B, N+1, nc]
    zL: torch.Tensor   # [B, N+1, nw]
    zU: torch.Tensor   # [B, N+1, nw]


class SolveResult(NamedTuple):
    W: torch.Tensor
    nu: torch.Tensor
    X: torch.Tensor        # [B, N+1, 4]
    U: torch.Tensor        # [B, N, 2]
    tau: torch.Tensor      # [B]
    obj: torch.Tensor
    err: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor
    mu: torch.Tensor
    duals: DualState


def _lane(mask, a):
    """Broadcast a lane mask [B] against a [B, ...] tensor."""
    return mask.reshape(mask.shape + (1,) * (a.dim() - 1))


def _amax(a):
    """Per-lane max over every non-batch axis."""
    return a.reshape(a.shape[0], -1).amax(dim=1)


def _amin(a):
    return a.reshape(a.shape[0], -1).amin(dim=1)


def _asum(a):
    return a.reshape(a.shape[0], -1).sum(dim=1)


def _all(a):
    return a.reshape(a.shape[0], -1).all(dim=1)


def _masks_and_bounds(L, spec, prob=nlp):
    active, is_eq = prob.constraint_masks(L, spec)
    eq_row = active * is_eq
    in_row = active * (1.0 - is_eq)
    lo, hi, has_lo, has_hi, _pin = prob.bound_arrays(L, spec)
    return (active, eq_row, in_row, lo[:, None], hi[:, None],
            has_lo[:, None], has_hi[:, None])


def default_init(spec, dtype=None, prob=nlp):
    """The problem family's cold-start warm start W [B, N+1, nw] (what a
    solve without W0 begins from)."""
    return prob.default_init(spec, dtype=dtype)


def _merit(L, W, s, spec, mu, rho, eq_row, in_row, lo, hi, has_lo, has_hi,
           prob=nlp):
    """Per-lane barrier merit [B] (inf outside the strict interior)."""
    f = prob.objective(L, W, spec)
    c = prob.all_constraints(L, W, spec)
    one = torch.ones((), dtype=W.dtype, device=W.device)
    slo = torch.where(has_lo > 0, W - lo, one)
    shi = torch.where(has_hi > 0, hi - W, one)
    good = (_all(slo > 0) & _all(shi > 0)
            & _all(torch.where(in_row > 0, s, one) > 0))
    bar = (_asum(torch.log(torch.clamp(slo, min=1e-300)) * (has_lo > 0))
           + _asum(torch.log(torch.clamp(shi, min=1e-300)) * (has_hi > 0))
           + _asum(torch.log(torch.clamp(s, min=1e-300)) * in_row))
    infeas = _asum(torch.abs(c) * eq_row) + _asum(torch.abs(c - s) * in_row)
    phi = f - mu * bar + rho * infeas
    return torch.where(good, phi, torch.full_like(phi, float("inf")))


def _repeat(t, n):
    return t.repeat_interleave(n, dim=0)


def _cold_duals(L, spec, W0, mu0_b, in_row, lo, hi, has_lo, has_hi,
                prob=nlp):
    """The cold dual start at W0 (barrier parameter mu0_b [B, 1, 1]):
    slacks max(c, 1e-2) and capped barrier-consistent multipliers on the
    inequality rows, mu / distance on the bounds."""
    one = torch.ones((), dtype=W0.dtype, device=W0.device)
    zero = torch.zeros((), dtype=W0.dtype, device=W0.device)
    c0 = prob.all_constraints(L, W0, spec)
    s0 = torch.where(in_row > 0, torch.clamp(c0, min=1e-2), one)
    # Capped barrier-consistent inequality multipliers (a warm start
    # violating an inequality would otherwise get y0 = mu/1e-2).
    nu0 = torch.where(in_row > 0, -torch.clamp(mu0_b / s0, max=1.0), zero)
    zL0 = torch.where(has_lo > 0, mu0_b / torch.clamp(W0 - lo, min=1e-4),
                      zero)
    zU0 = torch.where(has_hi > 0, mu0_b / torch.clamp(hi - W0, min=1e-4),
                      zero)
    return DualState(nu=nu0, s=s0, zL=zL0, zU=zU0)


def cold_dual_state(spec, cfg, W0, prob=nlp) -> DualState:
    """The solver's cold dual start at W0 (what a solve without
    ``duals0`` begins from), as a :class:`DualState` in ``cfg.dtype``.

    For callers that must pass a dual state, such as a warm re-solve
    after a failed one.  ``spec`` batched (W0 [B, N+1, nw]) or a single
    instance (W0 [N+1, nw]; the result then has no batch axis).
    """
    single = spec.x0.dim() == 1
    if single:
        spec, W0 = spec_mod.stack([spec]), W0[None]
    L = prob.layout_of(spec)
    dt = cfg.dtype
    spec = spec_mod.cast_floats(spec, dt)
    _, _, in_row, lo, hi, has_lo, has_hi = _masks_and_bounds(L, spec, prob)
    mu0_b = torch.full((spec.x0.shape[0], 1, 1), float(cfg.mu_init),
                       dtype=dt, device=spec.x0.device)
    d = _cold_duals(L, spec, W0.to(dt), mu0_b, in_row, lo, hi, has_lo,
                    has_hi, prob)
    return spec_mod.map_tensors(lambda t: t[0], d) if single else d


def _make_step(spec, cfg, W0=None, duals0: DualState | None = None,
               prob=nlp, debug: bool = False):
    """Build (initial state, step, layout, final_check) for a batch.

    ``spec`` leaves carry a leading B; W0 [B, N+1, nw] (None: cold
    start); duals0 an optional per-lane :class:`DualState`.  ``prob`` is
    the problem module: ``obca_torch.nlp`` (parking) or
    ``obca_torch.nav`` (point-mass navigation), each with the same
    stage-structured interface (``layout_of``, ``constraint_masks``,
    ``bound_arrays``, ``all_constraints``, ``objective``,
    ``total_lagrangian``, ``assemble_kkt_structured``,
    ``coupling_structure``, ``default_init``).

    ``step(state)`` runs one iteration; ``step.turn(state)`` is the
    same iteration as a generator that yields a ``kkt.FactorRequest`` at
    each factorization, which :func:`_run` captures as CUDA graphs.
    With ``debug`` the step returns (state, diag): per-lane [B]
    diagnostics with the JAX package's keys, which only read the step's
    values, so the state is the same bit for bit.
    """
    L = prob.layout_of(spec)
    e_rows, e_cols = prob.coupling_structure(L)
    dt = cfg.dtype
    fd = cfg.factor_dtype or dt
    rd = cfg.residual_dtype or dt
    spec = spec_mod.cast_floats(spec, dt)
    dev = spec.x0.device
    B = spec.x0.shape[0]
    active, eq_row, in_row, lo, hi, has_lo, has_hi = _masks_and_bounds(
        L, spec, prob)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    nw, nc = L.nw, L.nc

    tol = float(cfg.tol)
    mu_min = float(cfg.mu_min)
    mu_kappa = float(cfg.mu_kappa)
    mu_theta = float(cfg.mu_theta)
    kappa_eps = float(cfg.kappa_eps)
    tau_ftb = float(cfg.tau_ftb)
    delta_w0 = float(cfg.delta_w)
    delta_c = float(cfg.delta_c)
    merit_rho = float(cfg.merit_rho)
    delta_factor = float(cfg.delta_factor)
    step_max = float(cfg.step_max)

    if W0 is None:
        W0 = default_init(spec, dt, prob)
    W0 = W0.to(dt)
    # Anchor the proximal dual regularization at the warm-start duals.
    spec = dataclasses.replace(
        spec, dual_ref=torch.cat([W0[..., L.sl_lam], W0[..., L.sl_mu]], -1))

    def grad_lag(W, nu):
        return nlp.lagrangian_gradient(L, W, nu, spec, active,
                                       prob.total_lagrangian)

    mu0 = torch.full((B,), float(cfg.mu_init), dtype=dt, device=dev)
    if duals0 is not None:
        nu0 = torch.where(
            in_row > 0, torch.clamp(duals0.nu.to(dt), max=-1e-12),
            torch.where(eq_row > 0, duals0.nu.to(dt), zero))
        s0 = torch.where(in_row > 0, torch.clamp(duals0.s.to(dt), min=1e-10),
                         one)
        zL0 = torch.where(has_lo > 0,
                          torch.clamp(duals0.zL.to(dt), 1e-12, 1e12), zero)
        zU0 = torch.where(has_hi > 0,
                          torch.clamp(duals0.zU.to(dt), 1e-12, 1e12), zero)
    else:
        d0 = _cold_duals(L, spec, W0, mu0[:, None, None], in_row, lo, hi,
                         has_lo, has_hi, prob)
        nu0, s0, zL0, zU0 = d0.nu, d0.s, d0.zL, d0.zU

    if (duals0 is None or cfg.dual_ls_warm) and cfg.dual_init_ls:
        # Ipopt-style least-squares estimate of the equality multipliers
        # at the warm start, kept only where it halves the dual residual.
        gl0 = grad_lag(W0, nu0)
        sig_w0 = torch.ones_like(W0)
        sig_c0 = torch.where(eq_row > 0, -1e-4 * one, -one)
        rhs_w0 = -(gl0 - zL0 + zU0)
        rhs_c0 = torch.zeros_like(nu0)
        K0, ev0, rhs0 = prob.assemble_kkt_structured(
            L, W0, torch.zeros_like(nu0), sig_w0, sig_c0, rhs_w0, rhs_c0,
            spec, active, torch.zeros((B,), dtype=dt, device=dev))
        reg0 = torch.cat([torch.full((nw,), delta_factor, dtype=dt,
                                     device=dev),
                          torch.full((nc,), -delta_factor, dtype=dt,
                                     device=dev)]).expand(B, -1)
        kkt_ls = kkt.make_kkt_solver_se(nw, 4, fd, rd, e_rows, e_cols)
        d0, _ = kkt_ls(K0, ev0.to(dt), reg0, rhs0)
        nu_ls = d0[..., nw:]
        nu_cand = torch.where(eq_row > 0, nu0 + nu_ls, nu0)
        gl_ls = grad_lag(W0, nu_cand)
        rw_base = _amax(torch.abs(gl0 - zL0 + zU0))
        rw_ls = _amax(torch.abs(gl_ls - zL0 + zU0))
        ok_ls = (_amax(torch.abs(nu_ls)) <= 1e3) & (rw_ls <= 0.5 * rw_base)
        nu0 = torch.where(_lane(ok_ls, nu0), nu_cand, nu0)

    state0 = IpmState(
        W=W0, nu=nu0, s=s0, zL=zL0, zU=zU0, mu=mu0,
        delta_w=torch.full((B,), delta_w0, dtype=dt, device=dev),
        converged=torch.zeros((B,), dtype=torch.bool, device=dev),
        nan_fail=torch.zeros((B,), dtype=torch.bool, device=dev),
        iters=torch.zeros((B,), dtype=torch.int32, device=dev),
        err=torch.full((B,), float("inf"), dtype=dt, device=dev),
    )

    kkt_main = kkt.make_kkt_solver_se(nw, cfg.refine_iters, fd, rd,
                                      e_rows, e_cols)
    kkt_soc = kkt.make_kkt_solver_se(nw, 2, fd, rd, e_rows, e_cols)
    pat = kkt_main.pat
    ix = pat.index(dev)
    rows_t, cols_t = ix["rows"], ix["cols"]

    n_nu = (L.N + 1) * nc
    n_z = (L.N + 1) * nw
    # The constraint groups the debug diagnostics split.
    groups = dict(bc=L.r_bc, dyn=L.r_dyn,
                  tau=slice(L.i_taulink, L.i_taulink + 1), nrm=L.r_norm,
                  dst=L.r_dist, rate=L.r_rate)
    if hasattr(L, "r_obca_eq"):
        groups["oeq"] = L.r_obca_eq

    def kkt_error_pieces(gl, c, W, nu, s, zL, zU, mu):
        mu = mu[:, None, None]
        y = -nu
        rw = gl - zL + zU
        r_pri = torch.abs(c) * eq_row + torch.abs(c - s) * in_row
        comp_s = torch.abs(s * y - mu) * in_row
        comp_l = torch.abs((W - lo) * zL - mu) * (has_lo > 0)
        comp_u = torch.abs((hi - W) * zU - mu) * (has_hi > 0)
        s_d = torch.clamp(
            (_asum(torch.abs(nu)) + _asum(zL) + _asum(zU))
            / (n_nu + 2 * n_z) / 100.0, min=1.0)
        return torch.maximum(
            _amax(torch.abs(rw)) / s_d,
            torch.maximum(
                _amax(r_pri),
                torch.maximum(_amax(comp_s),
                              torch.maximum(_amax(comp_l), _amax(comp_u)))))

    def kkt_error(W, nu, s, zL, zU, mu):
        gl = grad_lag(W, nu)
        c = prob.all_constraints(L, W, spec)
        return kkt_error_pieces(gl, c, W, nu, s, zL, zU, mu)

    # Line search: the ls_steps trial points of every lane in one batch
    # of B * ls_steps lanes.
    n_ls = cfg.ls_steps
    spec_ls = spec_mod.map_tensors(lambda t: _repeat(t, n_ls), spec)
    ls_masks = [_repeat(t, n_ls) for t in (eq_row, in_row, lo, hi, has_lo,
                                           has_hi)]
    halves = 0.5 ** torch.arange(n_ls, dtype=dt, device=dev)

    def _ruiz(K, ev, rhs):
        """Symmetric Ruiz equilibration of (K, ev) with the coupling
        taking part through its sparse values: ``ruiz_se``, the scaling
        applied once (``ruiz_single_apply``)."""
        if cfg.ruiz_single_apply:
            if not cfg.ruiz_pow2:
                return bk.ruiz_se(K, ev, rhs, pat, cfg.ruiz_iters)
            dsc = bk.ruiz_se(K, ev, rhs, pat, cfg.ruiz_iters)[3]
            dsc = torch.exp2(torch.round(torch.log2(dsc)))
            K_s = K * dsc[:, :, :, None] * dsc[:, :, None, :]
            ev_s = ev * dsc[:, :-1, rows_t] * dsc[:, 1:, cols_t]
            return K_s, ev_s, rhs * dsc, dsc
        K_s, ev_s = K, ev
        dsc = torch.ones_like(rhs)
        for _ in range(cfg.ruiz_iters):
            rn = torch.abs(K_s).amax(-1)
            rn = bk.coupling_row_max(rn, torch.abs(ev_s), pat)
            d = 1.0 / torch.sqrt(torch.clamp(rn, min=1e-10))
            K_s = K_s * d[:, :, :, None] * d[:, :, None, :]
            ev_s = ev_s * d[:, :-1, rows_t] * d[:, 1:, cols_t]
            dsc = dsc * d
        return K_s, ev_s, rhs * dsc, dsc

    def ftb(val, dval, mask, tau_f):
        neg = (dval < 0) & (mask > 0)
        a = torch.where(neg, -tau_f * val / torch.where(neg, dval, -one),
                        torch.full_like(val, float("inf")))
        return _amin(a)

    def turn(state: IpmState):
        """One iteration as a generator: it yields a
        ``kkt.FactorRequest`` at each factorization, is sent back the
        factor, and returns the new state."""
        W, nu, s, zL, zU, mu = (state.W, state.nu, state.s, state.zL,
                                state.zU, state.mu)
        # --- residuals, convergence test, barrier update ---
        with trace.span("ipm.residuals"):
            y = torch.where(in_row > 0, -nu, one)
            gl = grad_lag(W, nu)
            c = prob.all_constraints(L, W, spec)
            err0 = kkt_error_pieces(gl, c, W, nu, s, zL, zU,
                                    torch.zeros_like(mu))
            err_mu = kkt_error_pieces(gl, c, W, nu, s, zL, zU, mu)
            conv = (err0 <= tol) & (mu <= 10.0 * mu_min)
            do_mu = (err_mu <= kappa_eps * mu) & (mu > mu_min) & ~conv
            mu_new = torch.clamp(
                torch.minimum(mu_kappa * mu, mu ** mu_theta), min=mu_min)
            mu = torch.where(do_mu, mu_new, mu)
            mu_b = mu[:, None, None]

        # --- assemble KKT ---
        with trace.span("ipm.assemble"):
            slo = torch.where(has_lo > 0, W - lo, one)
            shi = torch.where(has_hi > 0, hi - W, one)
            sigma_w = (torch.where(has_lo > 0, zL / slo, zero)
                       + torch.where(has_hi > 0, zU / shi, zero))
            sigma_c = (eq_row * (-delta_c) + in_row * (-(s / y) - delta_c)
                       + (1.0 - active) * (-1.0))
            rhs_w = (-gl + torch.where(has_lo > 0, mu_b / slo, zero)
                     - torch.where(has_hi > 0, mu_b / shi, zero))
            # Inactive rows solve -d_nu = nu (keeps their multipliers at 0).
            rhs_c = (eq_row * (-c) + in_row * (-(c - mu_b / y))
                     + (1.0 - active) * nu)
            K, ev, rhs = prob.assemble_kkt_structured(
                L, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec, active,
                state.delta_w)
            ev = ev.to(dt)
        with trace.span("ipm.ruiz"):
            K_s, ev_s, rhs_s, dsc = _ruiz(K, ev, rhs)

        # Factor a +-delta_factor-regularized copy, refine against the
        # true scaled system; the dual block keeps a fixed -delta_factor.
        df = torch.clamp(torch.clamp(state.delta_w, min=delta_factor),
                         max=1.0)
        reg = torch.cat([df[:, None].expand(B, nw),
                         torch.full((B, nc), -delta_factor, dtype=dt,
                                    device=dev)], dim=-1)
        d, lin_res = yield from kkt_main.steps(K_s, ev_s, reg, rhs_s)
        # Step-quality gate: never take a diverged refined solve.
        good_solve = lin_res <= 0.1 * (1.0 + _amax(torch.abs(rhs_s)))
        d = d * dsc
        dW = d[..., :nw]
        dnu = d[..., nw:]

        # --- recover eliminated directions ---
        with trace.span("ipm.recover_ftb"):
            dy = torch.where(in_row > 0, -dnu, zero)
            ds = torch.where(in_row > 0, (mu_b - s * y) / y - (s / y) * dy,
                             zero)
            dzL = torch.where(has_lo > 0,
                              (mu_b - slo * zL) / slo - (zL / slo) * dW, zero)
            dzU = torch.where(has_hi > 0,
                              (mu_b - shi * zU) / shi + (zU / shi) * dW, zero)

            # --- fraction-to-boundary ---
            tau_f = torch.clamp(1.0 - mu, min=tau_ftb)[:, None, None]
            hl = has_lo.expand_as(slo)
            hh = has_hi.expand_as(shi)
            a_pri = torch.clamp(torch.minimum(
                torch.minimum(ftb(s, ds, in_row, tau_f),
                              ftb(y, dy, in_row, tau_f)),
                torch.minimum(ftb(slo, dW, hl, tau_f),
                              ftb(shi, -dW, hh, tau_f))),
                max=1.0)
            a_pri = torch.minimum(
                a_pri, step_max / torch.clamp(_amax(torch.abs(dW)), min=1e-12))
            a_z = torch.clamp(torch.minimum(
                ftb(zL, dzL, has_lo.expand_as(zL), tau_f),
                ftb(zU, dzU, has_hi.expand_as(zU), tau_f)), max=1.0)

        # --- merit line search (all trial points in one batch) ---
        with trace.span("ipm.merit_ls"):
            rho = torch.clamp(2.0 * _amax(torch.abs(nu)), min=merit_rho)
            phi0 = _merit(L, W, s, spec, mu, rho, eq_row, in_row, lo, hi,
                          has_lo, has_hi, prob)
            alphas = a_pri[:, None] * halves                        # [B, ls]
            a4 = alphas[:, :, None, None]
            W_try = (W[:, None] + a4 * dW[:, None]).reshape(
                (B * n_ls,) + W.shape[1:])
            s_try = torch.where(in_row[:, None] > 0,
                                s[:, None] + a4 * ds[:, None],
                                one).reshape((B * n_ls,) + s.shape[1:])
            phis = _merit(L, W_try, s_try, spec_ls, _repeat(mu, n_ls),
                          _repeat(rho, n_ls), *ls_masks,
                          prob).reshape(B, n_ls)
            ok = phis <= (phi0[:, None]
                          - 1e-8 * alphas * torch.abs(phi0)[:, None])
            found = ok.any(dim=1)
            first = ok.to(torch.int8).argmax(dim=1)
            alpha = torch.where(found,
                                alphas.gather(1, first[:, None])[:, 0],
                                alphas[:, -1])

        # --- second-order correction ---
        with trace.span("ipm.soc"):
            a_pri_b = a_pri[:, None, None]
            W_full = W + a_pri_b * dW
            s_full = torch.where(in_row > 0, s + a_pri_b * ds, one)
            c_full = prob.all_constraints(L, W_full, spec)
            if cfg.soc:
                rhs_soc = torch.cat(
                    [torch.zeros_like(rhs_w),
                     eq_row * (-c_full) + in_row * (-(c_full - s_full))],
                    dim=-1)
                d_soc, _ = yield from kkt_soc.steps(K_s, ev_s, reg,
                                                    rhs_soc * dsc)
                d_soc = d_soc * dsc
                dW_soc = d_soc[..., :nw]
                dy_soc = torch.where(in_row > 0, -d_soc[..., nw:], zero)
                ds_soc = torch.where(in_row > 0, -(s / y) * dy_soc, zero)
            else:
                dW_soc = torch.zeros_like(W)
                ds_soc = torch.zeros_like(s)
            W_soc = W_full + dW_soc
            s_soc = torch.where(in_row > 0, s_full + ds_soc, one)
            soc_ok = (_all(torch.where(has_lo > 0, W_soc - lo, one) > 0)
                      & _all(torch.where(has_hi > 0, hi - W_soc, one) > 0)
                      & _all(torch.where(in_row > 0, s_soc, one) > 0))
            phi_soc = _merit(L, W_soc, s_soc, spec, mu, rho, eq_row, in_row,
                             lo, hi, has_lo, has_hi, prob)
            take_soc = (soc_ok & (phi_soc <= phi0 - 1e-8 * torch.abs(phi0))
                        & (alpha < a_pri) & cfg.soc)

        # --- watchdog: take the full step if it cuts the KKT error ---
        with trace.span("ipm.watchdog"):
            nu_full = nu + a_pri_b * dnu
            gl_full = grad_lag(W_full, nu_full)
            a_z_b = a_z[:, None, None]
            err_full = kkt_error_pieces(
                gl_full, c_full, W_full, nu_full, s_full,
                torch.clamp(zL + a_z_b * dzL, min=0.0),
                torch.clamp(zU + a_z_b * dzU, min=0.0), mu)
            take_full = (err_full <= 0.99 * err_mu) & cfg.watchdog

        # --- update ---
        with trace.span("ipm.update"):
            use_soc = take_soc & ~take_full
            alpha = torch.where(take_full, a_pri, alpha)
            alpha = torch.where(use_soc, a_pri, alpha)
            alpha_b = alpha[:, None, None]
            W_n = torch.where(_lane(use_soc, W), W_soc, W + alpha_b * dW)
            s_n = torch.where(_lane(use_soc, s), s_soc,
                              torch.where(in_row > 0, s + alpha_b * ds, one))
            nu_n = nu + alpha_b * dnu
            zL_n = zL + a_z_b * dzL
            zU_n = zU + a_z_b * dzU
            # z-safeguard (Ipopt's kappa_Sigma reset).
            slo_n = torch.where(has_lo > 0, W_n - lo, one)
            shi_n = torch.where(has_hi > 0, hi - W_n, one)
            kS = 1e10
            zL_n = torch.minimum(torch.maximum(zL_n, mu_b / (kS * slo_n)),
                                 kS * mu_b / slo_n)
            zU_n = torch.minimum(torch.maximum(zU_n, mu_b / (kS * shi_n)),
                                 kS * mu_b / shi_n)
            zL_n = torch.where(has_lo > 0, zL_n, zero)
            zU_n = torch.where(has_hi > 0, zU_n, zero)

            finite = (_all(torch.isfinite(W_n)) & _all(torch.isfinite(nu_n))
                      & _all(torch.isfinite(s_n)) & _all(torch.isfinite(zL_n))
                      & _all(torch.isfinite(zU_n)))
            if cfg.strict_steps:
                accepted = found | take_full | use_soc
            else:
                accepted = torch.ones_like(found)
            take = finite & good_solve & accepted & ~conv

            def sel(a, b):
                return torch.where(_lane(take, a), a, b)

            # Inertia correction by observation: decay delta_w on healthy
            # steps, bump it on NaN / failed search / crawl / boundary jam.
            ratio = alpha / torch.clamp(a_pri, min=1e-12)
            jam = a_pri < 3e-3
            healthy = take & ~jam & (take_full | use_soc | (ratio >= 0.24))
            crawl = (take & ~take_full & ~use_soc
                     & (~found | (ratio < 0.05) | jam))
            dw = state.delta_w
            delta_w_n = torch.where(
                healthy, torch.clamp(dw * 0.5, min=delta_w0),
                torch.where(
                    crawl | ((~finite | ~good_solve | ~accepted) & ~conv),
                    torch.clamp(dw * 10.0 + 1e-8, max=1e2), dw))
            delta_w_n = torch.where(conv, dw, delta_w_n)

            new_state = IpmState(
                W=sel(W_n, W), nu=sel(nu_n, nu), s=sel(s_n, s),
                zL=sel(zL_n, zL), zU=sel(zU_n, zU),
                mu=torch.where(conv, state.mu, mu), delta_w=delta_w_n,
                converged=conv, nan_fail=~finite & ~conv,
                iters=state.iters + (~conv).to(torch.int32),
                err=err0,
            )
        if not debug:
            return new_state
        # Diagnostics, per lane [B], from the values above (read only):
        # the linear residual of the unscaled system with E built from
        # the coupling values, the step's tests and lengths, residual
        # and multiplier maxima, and those maxima per constraint group.
        E_dbg = K.new_zeros((B, L.N, L.nz, L.nz))
        E_dbg[:, :, rows_t, cols_t] = ev
        r_abs = torch.abs(c) * eq_row + torch.abs(c - s) * in_row
        return new_state, dict(
            linres=_amax(torch.abs(blocktri.matvec(K, E_dbg, d) - rhs)),
            take_full=take_full, take_soc=use_soc, err_mu=err_mu,
            err0=err0, mu=mu, a_pri=a_pri, a_z=a_z, alpha=alpha,
            found=found, finite=finite, delta_w=dw,
            r_w=_amax(torch.abs(gl - zL + zU)), r_pri=_amax(r_abs),
            max_nu=_amax(torch.abs(nu)), dW=_amax(torch.abs(dW)),
            dnu=_amax(torch.abs(dnu)), phi0=phi0,
            dnu_g={g: _amax(torch.abs(dnu[..., sl]))
                   for g, sl in groups.items()},
            nu_g={g: _amax(torch.abs(nu[..., sl]))
                  for g, sl in groups.items()},
            rp_g={g: _amax(r_abs[..., sl]) for g, sl in groups.items()})

    def final_check(state: IpmState) -> IpmState:
        """The in-step convergence test lags one iteration; re-test the
        final iterate."""
        err0 = kkt_error(state.W, state.nu, state.s, state.zL, state.zU,
                         torch.zeros_like(state.mu))
        conv = state.converged | ((err0 <= tol) & (state.mu <= 10.0 * mu_min))
        return state._replace(
            err=torch.where(state.converged, state.err, err0),
            converged=conv)

    def step(state: IpmState) -> IpmState:
        return kkt.run(turn(state))

    step.turn = turn
    return state0, step, L, final_check


def _use_graphs(device) -> bool:
    """Whether :func:`_run` replays its turns as CUDA graphs: on a CUDA
    batch, not on the CPU."""
    return device.type == "cuda"


# device -> (graph pool, capture stream, anchor graph, its buffer).
_POOLS: dict = {}


def _graph_pool(device):
    """The memory pool and capture stream of every solve's graphs on
    ``device``.  A tiny graph captured into the pool holds it for the
    process, so that each solve's graphs reuse its memory after the
    previous solve's were released, instead of leaving a pool behind
    that only ``torch.cuda.empty_cache`` would free.  (A
    ``torch.cuda.MemPool`` does not do: in torch 2.11 a second capture
    into it after the first graph is freed fails an assertion of the
    pinned-host allocator.)"""
    if device not in _POOLS:
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        anchor = torch.cuda.CUDAGraph()
        one = torch.zeros((1,), device=device)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            anchor.capture_begin(pool=pool)
            one.add_(1.0)
            anchor.capture_end()
        _POOLS[device] = (pool, stream, anchor, one)
    return _POOLS[device][:2]


def _merge(new: IpmState, state: IpmState, running, max_iter: int):
    """The loop's update rule: the running lanes of ``new`` over
    ``state``, and the new running mask."""
    merged = IpmState(*[torch.where(_lane(running, a), a, b)
                        for a, b in zip(new, state)])
    return merged, ~merged.converged & (merged.iters < max_iter)


def _graph_turn(turn, state: IpmState, running, max_iter: int):
    """One loop turn of ``turn`` (a step's generator) in place: the state
    and the running mask :func:`_merge` gives written back into
    ``state`` and ``running``; returns whether any lane runs, on the
    device."""
    merged, now = _merge((yield from turn(state)), state, running, max_iter)
    for dst, src in zip((*state, running), (*merged, now)):
        dst.copy_(src)
    return running.any()


class _TurnGraphs:
    """The loop turn of :func:`_run` as CUDA graphs, cut at each
    factorization.

    Captured from ``turn`` (the step's generator) into static copies of
    the state and the running mask: the work before the first
    factorization, between two, and after the last is one graph each.
    The last one also merges the running lanes into the static state,
    writes it back and reduces the new running mask to one flag.  Each
    :meth:`replay` replays the graphs in order; between two it calls the
    factor kernel's wrapper eagerly on the first graph's outputs and
    copies its (Sinv, Wc) into the next graph's inputs.  A replay adds
    each graph's captured kernel launches to ``runtime.launches`` (the
    capture itself launches nothing, and its counts are taken back).
    """

    def __init__(self, turn, state: IpmState, running, max_iter: int):
        self.device = state.W.device
        self.state = IpmState(*[t.clone() for t in state])
        self.running = running.clone()
        self.graphs, self.launches = [], []
        self.requests, self.factors = [], []
        pool, stream = _graph_pool(self.device)
        gen = _graph_turn(turn, self.state, self.running, max_iter)
        done, out = False, None
        with torch.cuda.device(self.device):
            while not done:
                g = torch.cuda.CUDAGraph()
                before = dict(runtime.launches)
                with torch.cuda.stream(stream):
                    g.capture_begin(pool=pool)
                    try:
                        done, out = kkt.resume(
                            gen, self.factors[-1] if self.factors else None)
                    finally:
                        g.capture_end()
                self.launches.append({k: n - before[k]
                                      for k, n in runtime.launches.items()
                                      if n != before[k]})
                runtime.launches.update(before)
                self.graphs.append(g)
                if not done:
                    self.requests.append(out)
                    self.factors.append(out.outputs())
        self.go = out

    def replay(self):
        """One loop turn."""
        with torch.cuda.device(self.device):
            for i, g in enumerate(self.graphs):
                with trace.span("ipm.replay"):
                    g.replay()
                for k, n in self.launches[i].items():
                    runtime.launches[k] += n
                if i < len(self.requests):
                    Sinv, Wc = self.requests[i].factor()
                    self.factors[i][0].copy_(Sinv)
                    self.factors[i][1].copy_(Wc)


def _run(spec, cfg, W0=None, duals0: DualState | None = None,
         prob=nlp) -> SolveResult:
    """Solve a batch (``spec`` leaves [B, ...]) to convergence or cap.

    The first turn runs eagerly (on a CUDA batch it is also the warm-up
    that capture needs); on a CUDA batch the second turn captures
    :class:`_TurnGraphs`, and it and every later turn replay them.  The
    graphs are released when the call returns."""
    with torch.no_grad(), trace.span("ipm.solve"):
        with trace.span("ipm.setup"):
            state, step, L, final_check = _make_step(spec, cfg, W0, duals0,
                                                     prob)
        B = state.W.shape[0]
        running = ~state.converged & (state.iters < cfg.max_iter)
        with trace.span("ipm.sync"):
            go = bool(running.any())
        graphs, turns = None, 0
        while go:
            with trace.span("ipm.iter"):
                trace.count("ipm.iters")
                trace.count("ipm.lane_slots", B)
                if graphs is None and turns and _use_graphs(state.W.device):
                    with trace.span("ipm.capture"):
                        graphs = _TurnGraphs(step.turn, state, running,
                                             cfg.max_iter)
                    trace.count("ipm.graph_captures")
                if graphs is None:
                    state, running = _merge(step(state), state, running,
                                            cfg.max_iter)
                    with trace.span("ipm.sync"):
                        go = bool(running.any())
                else:
                    graphs.replay()
                    trace.count("ipm.graph_replays")
                    state = graphs.state
                    with trace.span("ipm.sync"):
                        go = bool(graphs.go)
            turns += 1
        del graphs
        with trace.span("ipm.final"):
            final = final_check(state)
            W = final.W
            status = torch.where(
                final.converged, STATUS_CONVERGED,
                torch.where(final.nan_fail, STATUS_NAN, STATUS_RUNNING))
            pdt = torch.promote_types(W.dtype, spec.x0.dtype)
            obj = prob.objective(L, W.to(pdt),
                                 spec_mod.cast_floats(spec, pdt))
        return SolveResult(
            W=W, nu=final.nu, X=W[..., L.sl_x], U=W[:, :L.N, L.sl_u],
            tau=W[:, 0, L.i_tau], obj=obj, err=final.err, iters=final.iters,
            status=status, mu=final.mu,
            duals=DualState(nu=final.nu, s=final.s, zL=final.zL,
                            zU=final.zU))


def solve_single(spec, cfg, W0=None, duals0: DualState | None = None,
                 prob=nlp):
    """Solve one instance (unbatched spec, W0 [N+1, nw]); the result's
    fields carry no batch axis."""
    specs = spec_mod.stack([spec])
    d0 = None if duals0 is None else spec_mod.map_tensors(
        lambda t: t[None], duals0)
    res = _run(specs, cfg, None if W0 is None else W0[None], d0, prob)
    return SolveResult(*[
        spec_mod.map_tensors(lambda t: t[0], f) for f in res])


def debug_iterate(spec, cfg, W0=None, n_iter: int = 30, printer=print,
                  prob=nlp, duals0: DualState | None = None):
    """Host-side iteration loop with per-iteration diagnostics for one
    instance (unbatched spec, W0 [N+1, nw]): up to ``n_iter`` steps of
    the debug step, two lines each through ``printer`` (the JAX
    package's), stopping at convergence.  Returns the final state
    without a batch axis."""
    specs = spec_mod.stack([spec])
    d0 = None if duals0 is None else spec_mod.map_tensors(
        lambda t: t[None], duals0)
    with torch.no_grad():
        state, step, _L, _final_check = _make_step(
            specs, cfg, None if W0 is None else W0[None], d0, prob,
            debug=True)
        for i in range(n_iter):
            state, diag = step(state)
            printer(
                f"it {i:3d} mu={float(diag['mu']):.2e} "
                f"err_mu={float(diag['err_mu']):.2e} "
                f"err0={float(diag['err0']):.2e} "
                f"rw={float(diag['r_w']):.2e} "
                f"rp={float(diag['r_pri']):.2e} "
                f"a={float(diag['alpha']):.2e}/{float(diag['a_pri']):.2e} "
                f"found={bool(diag['found'])} fin={bool(diag['finite'])} "
                f"dw={float(diag['delta_w']):.1e} "
                f"|dW|={float(diag['dW']):.1e} "
                f"|nu|={float(diag['max_nu']):.1e}"
                f" lin={float(diag['linres']):.1e}"
                f" full={int(diag['take_full'])} "
                f"soc={int(diag['take_soc'])}")
            # Groups in name order, as the JAX package's jitted step
            # returns its dicts.
            printer(
                "      dnu: " + " ".join(
                    f"{g}={float(v):.1e}"
                    for g, v in sorted(diag["dnu_g"].items()))
                + " | rp: " + " ".join(
                    f"{g}={float(v):.1e}"
                    for g, v in sorted(diag["rp_g"].items())))
            if bool(state.converged):
                printer("converged")
                break
    return IpmState(*[t[0] for t in state])


def solve_batch(specs, cfg, W0=None, prob=nlp,
                duals0: DualState | None = None):
    """Solve a stacked-spec batch (leading axis B on every leaf), from
    the per-lane warm starts W0 [B, N+1, nw] and, if given, the per-lane
    dual state ``duals0``."""
    return _run(specs, cfg, W0, duals0, prob)


def solve_free_time(spec, cfg, W0=None, prob=nlp):
    """Free-time solve (``fix_time=False``: the horizon's time scaling
    tau is a variable) by homotopy: the fixed-time problem first, then
    the free-time problem warm-started from its solution and its full
    dual state at mu_init = min(mu_init, 1e-3).  A cold free-time solve
    wanders: the global time-scaling column makes the first barrier
    subproblems nearly singular along tau.

    ``spec`` batched (W0 [B, N+1, nw]) or a single instance (W0
    [N+1, nw]; the result then has no batch axis).  Returns the
    free-time result.
    """
    single = spec.x0.dim() == 1
    specs = spec_mod.stack([spec]) if single else spec
    if W0 is not None and single:
        W0 = W0[None]
    res_fix = _run(dataclasses.replace(specs, fix_time=True), cfg, W0,
                   prob=prob)
    cfg_free = dataclasses.replace(
        cfg, mu_init=torch.clamp(cfg.mu_init, max=1e-3))
    res = _run(specs, cfg_free, res_fix.W, res_fix.duals, prob)
    if single:
        return SolveResult(*[
            spec_mod.map_tensors(lambda t: t[0], f) for f in res])
    return res


def donor_features(specs):
    """Per-lane rescue-donor features: start pose, goal position and the
    obstacle halfspace offsets (a donor must share the geometry)."""
    B = specs.x0.shape[0]
    return torch.cat([specs.x0, specs.xF[:, :2],
                      specs.obstacles.b.reshape(B, -1)], dim=-1)


def solve_batch_rescued(specs, cfg, W0=None, prob=nlp,
                        rescue_mu: float = 1e-5, rescue_rounds: int = 2,
                        rescue_max_iter: int = 25):
    """Batched solve with neighbour-seeded rescue rounds.

    Pass 1 solves every lane from W0.  Each rescue round re-solves the
    lanes that did not converge, seeded from their nearest converged
    neighbour (``donor_features`` distance; ties to the first index) —
    its primal trajectory and full dual state — at mu = ``rescue_mu``.
    Round 1 keeps the caller's iteration cap, later rounds cap at
    ``rescue_max_iter``.  A round is skipped when the batch is clean or
    has no donor.  ``iters`` counts pass 1 plus the rounds a lane ran.

    The JAX package re-solves every lane under ``vmap`` and discards the
    converged lanes' second results; since lanes are independent, the
    port re-solves only the failed lanes (same per-lane results).
    """
    res = solve_batch(specs, cfg, W0, prob)
    feats = donor_features(specs)
    d2_all = torch.sum((feats[:, None, :] - feats[None, :, :]) ** 2, dim=-1)
    cfg2 = dataclasses.replace(
        cfg, mu_init=torch.as_tensor(rescue_mu, dtype=torch.float64))
    cfg2_tail = dataclasses.replace(
        cfg2, max_iter=min(rescue_max_iter, cfg.max_iter))

    for r in range(rescue_rounds):
        cfg_r = cfg2 if r == 0 else cfg2_tail
        ok1 = res.status == STATUS_CONVERGED
        with trace.span("ipm.sync"):
            skip = bool(ok1.all()) or not bool(ok1.any())
        if skip:
            continue
        with trace.span("ipm.rescue"):
            d2 = torch.where(ok1[None, :], d2_all,
                             torch.full_like(d2_all, float("inf")))
            donor = torch.argmin(d2, dim=1)
            with trace.span("ipm.sync"):
                fail = torch.nonzero(~ok1).flatten()
            trace.count("ipm.rescue_lanes", fail.numel())
            src = donor[fail]
            duals_seed = spec_mod.map_tensors(lambda t: t[src], res.duals)
            res2 = _run(spec_mod.take(specs, fail), cfg_r, res.W[src],
                        duals_seed, prob)
            iters = res.iters.index_copy(0, fail,
                                         res.iters[fail] + res2.iters)
            duals = DualState(*[
                getattr(res.duals, f.name).index_copy(
                    0, fail, getattr(res2.duals, f.name))
                for f in dataclasses.fields(DualState)])
            res = SolveResult(*[
                a.index_copy(0, fail, b)
                for a, b in zip(res[:-1], res2[:-1])],
                duals=duals)._replace(iters=iters)
    return res
