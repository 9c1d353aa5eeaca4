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

Status codes: 0 = converged, 1 = running/max-iter, 2 = NaN-guarded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from obca_torch import nlp
from obca_torch import spec as spec_mod
from obca_torch.solver import kkt

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


def _masks_and_bounds(L, spec):
    active, is_eq = nlp.constraint_masks(L, spec)
    eq_row = active * is_eq
    in_row = active * (1.0 - is_eq)
    lo, hi, has_lo, has_hi, _pin = nlp.bound_arrays(L, spec)
    return (active, eq_row, in_row, lo[:, None], hi[:, None],
            has_lo[:, None], has_hi[:, None])


def _merit(L, W, s, spec, mu, rho, eq_row, in_row, lo, hi, has_lo, has_hi):
    """Per-lane barrier merit [B] (inf outside the strict interior)."""
    f = nlp.objective(L, W, spec)
    c = nlp.all_constraints(L, W, spec)
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


def _make_step(spec, cfg, W0=None, duals0: DualState | None = None):
    """Build (initial state, step, layout, final_check) for a batch.

    ``spec`` leaves carry a leading B; W0 [B, N+1, nw] (None: cold
    start); duals0 an optional per-lane :class:`DualState`.
    """
    L = nlp.layout_of(spec)
    e_rows, e_cols = nlp.coupling_structure(L)
    dt = cfg.dtype
    fd = cfg.factor_dtype or dt
    rd = cfg.residual_dtype or dt
    spec = spec_mod.cast_floats(spec, dt)
    dev = spec.x0.device
    B = spec.x0.shape[0]
    active, eq_row, in_row, lo, hi, has_lo, has_hi = _masks_and_bounds(
        L, spec)
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
        W0 = nlp.default_init(spec, dt)
    W0 = W0.to(dt)
    # Anchor the proximal dual regularization at the warm-start duals.
    spec = dataclasses.replace(
        spec, dual_ref=torch.cat([W0[..., L.sl_lam], W0[..., L.sl_mu]], -1))

    def grad_lag(W, nu):
        return nlp.lagrangian_gradient(L, W, nu, spec, active)

    mu0 = torch.full((B,), float(cfg.mu_init), dtype=dt, device=dev)
    mu0_b = mu0[:, None, None]
    c0 = nlp.all_constraints(L, W0, spec)
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
        s0 = torch.where(in_row > 0, torch.clamp(c0, min=1e-2), one)
        # Capped barrier-consistent inequality multipliers (a warm start
        # violating an inequality would otherwise get y0 = mu/1e-2).
        nu0 = torch.where(in_row > 0, -torch.clamp(mu0_b / s0, max=1.0),
                          zero)
        zL0 = torch.where(has_lo > 0,
                          mu0_b / torch.clamp(W0 - lo, min=1e-4), zero)
        zU0 = torch.where(has_hi > 0,
                          mu0_b / torch.clamp(hi - W0, min=1e-4), zero)

    if (duals0 is None or cfg.dual_ls_warm) and cfg.dual_init_ls:
        # Ipopt-style least-squares estimate of the equality multipliers
        # at the warm start, kept only where it halves the dual residual.
        gl0 = grad_lag(W0, nu0)
        sig_w0 = torch.ones_like(W0)
        sig_c0 = torch.where(eq_row > 0, -1e-4 * one, -one)
        rhs_w0 = -(gl0 - zL0 + zU0)
        rhs_c0 = torch.zeros_like(nu0)
        K0, ev0, rhs0 = nlp.assemble_kkt_structured(
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
    rows_t = torch.as_tensor(e_rows, device=dev)
    cols_t = torch.as_tensor(e_cols, device=dev)

    n_nu = (L.N + 1) * nc
    n_z = (L.N + 1) * nw

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
        c = nlp.all_constraints(L, W, spec)
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
        taking part through its sparse values."""
        def coupling_row_norms(rn, aev_s):
            # rn[:, :-1, rows_j] = max(., aev_s_j); rn[:, 1:, cols_j] = ...
            idx_r = rows_t.expand_as(aev_s)
            idx_c = cols_t.expand_as(aev_s)
            rn = rn.clone()
            rn[:, :-1] = rn[:, :-1].scatter_reduce(2, idx_r, aev_s, "amax",
                                                   include_self=True)
            rn[:, 1:] = rn[:, 1:].scatter_reduce(2, idx_c, aev_s, "amax",
                                                 include_self=True)
            return rn

        if cfg.ruiz_single_apply:
            aK = torch.abs(K)
            aev = torch.abs(ev)
            dsc = torch.ones_like(rhs)
            for _ in range(cfg.ruiz_iters):
                rn = (aK * dsc[:, :, None, :]).amax(-1) * dsc
                aev_s = aev * dsc[:, :-1, rows_t] * dsc[:, 1:, cols_t]
                rn = coupling_row_norms(rn, aev_s)
                dsc = dsc / torch.sqrt(torch.clamp(rn, min=1e-10))
            if cfg.ruiz_pow2:
                dsc = torch.exp2(torch.round(torch.log2(dsc)))
            K_s = K * dsc[:, :, :, None] * dsc[:, :, None, :]
            ev_s = ev * dsc[:, :-1, rows_t] * dsc[:, 1:, cols_t]
            return K_s, ev_s, rhs * dsc, dsc
        K_s, ev_s = K, ev
        dsc = torch.ones_like(rhs)
        for _ in range(cfg.ruiz_iters):
            rn = torch.abs(K_s).amax(-1)
            rn = coupling_row_norms(rn, torch.abs(ev_s))
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

    def step(state: IpmState) -> IpmState:
        W, nu, s, zL, zU, mu = (state.W, state.nu, state.s, state.zL,
                                state.zU, state.mu)
        y = torch.where(in_row > 0, -nu, one)

        # --- residuals, convergence test, barrier update ---
        gl = grad_lag(W, nu)
        c = nlp.all_constraints(L, W, spec)
        err0 = kkt_error_pieces(gl, c, W, nu, s, zL, zU, torch.zeros_like(mu))
        err_mu = kkt_error_pieces(gl, c, W, nu, s, zL, zU, mu)
        conv = (err0 <= tol) & (mu <= 10.0 * mu_min)
        do_mu = (err_mu <= kappa_eps * mu) & (mu > mu_min) & ~conv
        mu_new = torch.clamp(torch.minimum(mu_kappa * mu, mu ** mu_theta),
                             min=mu_min)
        mu = torch.where(do_mu, mu_new, mu)
        mu_b = mu[:, None, None]

        # --- assemble KKT ---
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
        K, ev, rhs = nlp.assemble_kkt_structured(
            L, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec, active,
            state.delta_w)
        ev = ev.to(dt)
        K_s, ev_s, rhs_s, dsc = _ruiz(K, ev, rhs)

        # Factor a +-delta_factor-regularized copy, refine against the
        # true scaled system; the dual block keeps a fixed -delta_factor.
        df = torch.clamp(torch.clamp(state.delta_w, min=delta_factor),
                         max=1.0)
        reg = torch.cat([df[:, None].expand(B, nw),
                         torch.full((B, nc), -delta_factor, dtype=dt,
                                    device=dev)], dim=-1)
        d, lin_res = kkt_main(K_s, ev_s, reg, rhs_s)
        # Step-quality gate: never take a diverged refined solve.
        good_solve = lin_res <= 0.1 * (1.0 + _amax(torch.abs(rhs_s)))
        d = d * dsc
        dW = d[..., :nw]
        dnu = d[..., nw:]

        # --- recover eliminated directions ---
        dy = torch.where(in_row > 0, -dnu, zero)
        ds = torch.where(in_row > 0, (mu_b - s * y) / y - (s / y) * dy, zero)
        dzL = torch.where(has_lo > 0,
                          (mu_b - slo * zL) / slo - (zL / slo) * dW, zero)
        dzU = torch.where(has_hi > 0,
                          (mu_b - shi * zU) / shi + (zU / shi) * dW, zero)

        # --- fraction-to-boundary ---
        tau_f = torch.clamp(1.0 - mu, min=tau_ftb)[:, None, None]
        hl = has_lo.expand_as(slo)
        hh = has_hi.expand_as(shi)
        a_pri = torch.clamp(torch.minimum(
            torch.minimum(ftb(s, ds, in_row, tau_f), ftb(y, dy, in_row, tau_f)),
            torch.minimum(ftb(slo, dW, hl, tau_f), ftb(shi, -dW, hh, tau_f))),
            max=1.0)
        a_pri = torch.minimum(
            a_pri, step_max / torch.clamp(_amax(torch.abs(dW)), min=1e-12))
        a_z = torch.clamp(torch.minimum(
            ftb(zL, dzL, has_lo.expand_as(zL), tau_f),
            ftb(zU, dzU, has_hi.expand_as(zU), tau_f)), max=1.0)

        # --- merit line search (all trial points in one batch) ---
        rho = torch.clamp(2.0 * _amax(torch.abs(nu)), min=merit_rho)
        phi0 = _merit(L, W, s, spec, mu, rho, eq_row, in_row, lo, hi,
                      has_lo, has_hi)
        alphas = a_pri[:, None] * halves                        # [B, ls]
        a4 = alphas[:, :, None, None]
        W_try = (W[:, None] + a4 * dW[:, None]).reshape(
            (B * n_ls,) + W.shape[1:])
        s_try = torch.where(in_row[:, None] > 0, s[:, None] + a4 * ds[:, None],
                            one).reshape((B * n_ls,) + s.shape[1:])
        phis = _merit(L, W_try, s_try, spec_ls, _repeat(mu, n_ls),
                      _repeat(rho, n_ls), *ls_masks).reshape(B, n_ls)
        ok = phis <= phi0[:, None] - 1e-8 * alphas * torch.abs(phi0)[:, None]
        found = ok.any(dim=1)
        first = ok.to(torch.int8).argmax(dim=1)
        alpha = torch.where(found,
                            alphas.gather(1, first[:, None])[:, 0],
                            alphas[:, -1])

        # --- second-order correction ---
        a_pri_b = a_pri[:, None, None]
        W_full = W + a_pri_b * dW
        s_full = torch.where(in_row > 0, s + a_pri_b * ds, one)
        c_full = nlp.all_constraints(L, W_full, spec)
        if cfg.soc:
            rhs_soc = torch.cat(
                [torch.zeros_like(rhs_w),
                 eq_row * (-c_full) + in_row * (-(c_full - s_full))], dim=-1)
            d_soc, _ = kkt_soc(K_s, ev_s, reg, rhs_soc * dsc)
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
        phi_soc = _merit(L, W_soc, s_soc, spec, mu, rho, eq_row, in_row, lo,
                         hi, has_lo, has_hi)
        take_soc = (soc_ok & (phi_soc <= phi0 - 1e-8 * torch.abs(phi0))
                    & (alpha < a_pri) & cfg.soc)

        # --- watchdog: take the full step if it cuts the KKT error ---
        nu_full = nu + a_pri_b * dnu
        gl_full = grad_lag(W_full, nu_full)
        a_z_b = a_z[:, None, None]
        err_full = kkt_error_pieces(
            gl_full, c_full, W_full, nu_full, s_full,
            torch.clamp(zL + a_z_b * dzL, min=0.0),
            torch.clamp(zU + a_z_b * dzU, min=0.0), mu)
        take_full = (err_full <= 0.99 * err_mu) & cfg.watchdog

        # --- update ---
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
        crawl = take & ~take_full & ~use_soc & (~found | (ratio < 0.05) | jam)
        dw = state.delta_w
        delta_w_n = torch.where(
            healthy, torch.clamp(dw * 0.5, min=delta_w0),
            torch.where(crawl | ((~finite | ~good_solve | ~accepted) & ~conv),
                        torch.clamp(dw * 10.0 + 1e-8, max=1e2), dw))
        delta_w_n = torch.where(conv, dw, delta_w_n)

        return IpmState(
            W=sel(W_n, W), nu=sel(nu_n, nu), s=sel(s_n, s),
            zL=sel(zL_n, zL), zU=sel(zU_n, zU),
            mu=torch.where(conv, state.mu, mu), delta_w=delta_w_n,
            converged=conv, nan_fail=~finite & ~conv,
            iters=state.iters + (~conv).to(torch.int32),
            err=err0,
        )

    def final_check(state: IpmState) -> IpmState:
        """The in-step convergence test lags one iteration; re-test the
        final iterate."""
        err0 = kkt_error(state.W, state.nu, state.s, state.zL, state.zU,
                         torch.zeros_like(state.mu))
        conv = state.converged | ((err0 <= tol) & (state.mu <= 10.0 * mu_min))
        return state._replace(
            err=torch.where(state.converged, state.err, err0),
            converged=conv)

    return state0, step, L, final_check


def _run(spec, cfg, W0=None, duals0: DualState | None = None) -> SolveResult:
    """Solve a batch (``spec`` leaves [B, ...]) to convergence or cap."""
    with torch.no_grad():
        state, step, L, final_check = _make_step(spec, cfg, W0, duals0)
        running = ~state.converged & (state.iters < cfg.max_iter)
        while bool(running.any()):
            new = step(state)
            state = IpmState(*[torch.where(_lane(running, a), a, b)
                               for a, b in zip(new, state)])
            running = ~state.converged & (state.iters < cfg.max_iter)
        final = final_check(state)
        W = final.W
        status = torch.where(
            final.converged, STATUS_CONVERGED,
            torch.where(final.nan_fail, STATUS_NAN, STATUS_RUNNING))
        pdt = torch.promote_types(W.dtype, spec.x0.dtype)
        obj = nlp.objective(L, W.to(pdt), spec_mod.cast_floats(spec, pdt))
        return SolveResult(
            W=W, nu=final.nu, X=W[..., L.sl_x], U=W[:, :L.N, L.sl_u],
            tau=W[:, 0, L.i_tau], obj=obj, err=final.err, iters=final.iters,
            status=status, mu=final.mu,
            duals=DualState(nu=final.nu, s=final.s, zL=final.zL,
                            zU=final.zU))


def solve_single(spec, cfg, W0=None, duals0: DualState | None = None):
    """Solve one instance (unbatched spec, W0 [N+1, nw]); the result's
    fields carry no batch axis."""
    specs = spec_mod.stack([spec])
    d0 = None if duals0 is None else spec_mod.map_tensors(
        lambda t: t[None], duals0)
    res = _run(specs, cfg, None if W0 is None else W0[None], d0)
    return SolveResult(*[
        spec_mod.map_tensors(lambda t: t[0], f) for f in res])


def solve_batch(specs, cfg, W0=None):
    """Solve a stacked-spec batch (leading axis B on every leaf)."""
    return _run(specs, cfg, W0)


def donor_features(specs):
    """Per-lane rescue-donor features: start pose, goal position and the
    obstacle halfspace offsets (a donor must share the geometry)."""
    B = specs.x0.shape[0]
    return torch.cat([specs.x0, specs.xF[:, :2],
                      specs.obstacles.b.reshape(B, -1)], dim=-1)


def solve_batch_rescued(specs, cfg, W0=None, rescue_mu: float = 1e-5,
                        rescue_rounds: int = 2, rescue_max_iter: int = 25):
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
    res = solve_batch(specs, cfg, W0)
    feats = donor_features(specs)
    d2_all = torch.sum((feats[:, None, :] - feats[None, :, :]) ** 2, dim=-1)
    cfg2 = dataclasses.replace(
        cfg, mu_init=torch.as_tensor(rescue_mu, dtype=torch.float64))
    cfg2_tail = dataclasses.replace(
        cfg2, max_iter=min(rescue_max_iter, cfg.max_iter))

    for r in range(rescue_rounds):
        cfg_r = cfg2 if r == 0 else cfg2_tail
        ok1 = res.status == STATUS_CONVERGED
        if bool(ok1.all()) or not bool(ok1.any()):
            continue
        d2 = torch.where(ok1[None, :], d2_all,
                         torch.full_like(d2_all, float("inf")))
        donor = torch.argmin(d2, dim=1)
        fail = torch.nonzero(~ok1).flatten()
        src = donor[fail]
        duals_seed = spec_mod.map_tensors(lambda t: t[src], res.duals)
        res2 = _run(spec_mod.take(specs, fail), cfg_r, res.W[src],
                    duals_seed)
        iters = res.iters.index_copy(0, fail, res.iters[fail] + res2.iters)
        duals = DualState(*[
            getattr(res.duals, f.name).index_copy(
                0, fail, getattr(res2.duals, f.name))
            for f in dataclasses.fields(DualState)])
        res = SolveResult(*[
            a.index_copy(0, fail, b) for a, b in zip(res[:-1], res2[:-1])],
            duals=duals)._replace(iters=iters)
    return res
