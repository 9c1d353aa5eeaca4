"""Point-mass navigation OBCA problem (the second problem family).

Port of ``obca_tpu.nav`` with an explicit leading batch axis B, like
:mod:`obca_torch.nlp`.  A point mass navigates convex obstacles with
the *distance* variant of the dual reformulation and lambda-only duals
(no ego polytope, so no mu and no rotation-equality rows):

    dist(p, O_m) >= d_min  <=>  exists lam_m >= 0:
        (A_m p - b_m)' lam_m >= d_min,   ||A_m' lam_m||_2 <= 1

The module has the stage-structured interface of :mod:`obca_torch.nlp`,
so the batched interior-point solver runs it unchanged
(``ipm.solve_batch(specs, cfg, prob=nav)``).  Stage layout (indices
mirror the parking layout, so the constant-coupling machinery of
``nlp`` is reused):

  w_k = [p(2) v(2) | u(2) | tau(1) | lam(M*V)]          nw = 7 + M*V
  c_k = [bc(4) dyn(4) taulink(1) norm(M) dist(M) rate(4)]  nc = 13 + 2M

Dynamics: 2-D double integrator (midpoint Euler, optional free-time
scaling tau):

    p+ = p + tau*Ts * (v + tau*Ts/2 * a),   v+ = v + tau*Ts * a

Unlike the parking problem, the constraint blocks of the KKT assembly
come from automatic differentiation (``nlp.constraint_blocks``), as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from obca_torch import nlp, obca, trace
from obca_torch._util import linspace, one_hot
from obca_torch.spec import Obstacles, obstacles_from_vertices

PIN_KAPPA = nlp.PIN_KAPPA


@dataclasses.dataclass(frozen=True)
class NavSpec:
    """One point-mass navigation instance, or a batch (leading axis B
    on every tensor leaf): state x = (X, Y, vx, vy), input u = (ax, ay).
    Field names are shared with ``ProblemSpec`` wherever the solver
    touches them (Ts, du_max, u_prev, r_u, r_du, q_time, w_reg,
    dual_ref, tau bounds)."""

    x0: torch.Tensor          # [4] (X, Y, vx, vy)
    xF: torch.Tensor          # [4]
    Ts: torch.Tensor          # []
    obstacles: Obstacles
    u_lo: torch.Tensor        # [2] acceleration bounds
    u_hi: torch.Tensor        # [2]
    v_lo: torch.Tensor        # [2] velocity bounds
    v_hi: torch.Tensor        # [2]
    xy_lo: torch.Tensor       # [2]
    xy_hi: torch.Tensor       # [2]
    du_max: torch.Tensor      # [2] acceleration-rate bound (< 0 disables)
    u_prev: torch.Tensor      # [2]
    d_min: torch.Tensor       # []
    r_u: torch.Tensor         # [2]
    r_du: torch.Tensor        # [2]
    q_time: torch.Tensor      # [2]
    w_reg: torch.Tensor       # []
    dual_ref: torch.Tensor    # [N+1, M*V]
    tau_lo: torch.Tensor      # []
    tau_hi: torch.Tensor      # []
    N: int = 60
    fix_time: bool = True
    max_obs: int = 4
    max_faces: int = 4


@dataclasses.dataclass(frozen=True)
class NavLayout:
    """Static index layout (the subset of ``nlp.Layout`` the solver
    uses)."""

    N: int
    M: int
    V: int
    fix_time: bool

    @property
    def sl_x(self):
        return slice(0, 4)

    @property
    def sl_u(self):
        return slice(4, 6)

    @property
    def i_tau(self):
        return 6

    @property
    def sl_lam(self):
        return slice(7, 7 + self.M * self.V)

    @property
    def sl_mu(self):
        # No ego-face duals: the empty slice keeps the solver's dual_ref
        # concatenation valid.
        return slice(7 + self.M * self.V, 7 + self.M * self.V)

    @property
    def nw(self):
        return 7 + self.M * self.V

    @property
    def r_bc(self):
        return slice(0, 4)

    @property
    def r_dyn(self):
        return slice(4, 8)

    @property
    def i_taulink(self):
        return 8

    @property
    def r_norm(self):
        return slice(9, 9 + self.M)

    @property
    def r_dist(self):
        return slice(9 + self.M, 9 + 2 * self.M)

    @property
    def r_rate(self):
        return slice(9 + 2 * self.M, 13 + 2 * self.M)

    @property
    def nc(self):
        return 13 + 2 * self.M

    @property
    def nz(self):
        return self.nw + self.nc


def layout_of(spec) -> NavLayout:
    return NavLayout(N=spec.N, M=spec.max_obs, V=spec.max_faces,
                     fix_time=spec.fix_time)


def point_step(x, u, tau, Ts):
    """Double-integrator step (midpoint Euler, time scaling tau): x
    [..., 4], u [..., 2], tau and Ts broadcastable to x[..., 0]."""
    p, v = x[..., :2], x[..., 2:]
    h = (tau * Ts)[..., None]
    return torch.cat([p + h * (v + 0.5 * h * u), v + h * u], dim=-1)


def rollout(x0, U, tau, Ts):
    """Roll the horizon: x0 [..., 4], U [..., N, 2] -> states
    [..., N+1, 4] (a host loop over the N steps)."""
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(point_step(xs[-1], U[..., k, :], tau, Ts))
    return torch.stack(xs, dim=-2)


# ---------------------------------------------------------------------------
# Constraints (the aux convention of the parking problem, so
# nlp.stage_aux and nlp.constraint_blocks are reused).
# ---------------------------------------------------------------------------


def stage_constraints_local(L: NavLayout, w, aux, spec, k):
    """Constraint rows c_k [..., nc] of stages w [..., nw]; ``aux`` =
    (x_next, tau_next, u_prev), ``k`` the stage index, the spec leaves
    broadcast against w's leading axes (as
    ``nlp.stage_constraints_local``)."""
    dt = w.dtype
    x = w[..., L.sl_x]
    u = w[..., L.sl_u]
    tau = w[..., L.i_tau]
    lam = w[..., L.sl_lam].reshape(w.shape[:-1] + (L.M, L.V))
    x_next, tau_next, u_prev = aux

    is0 = (k == 0).to(dt)[..., None]
    c_bc = x - (is0 * spec.x0 + (1.0 - is0) * spec.xF)
    if L.fix_time:
        # Local tau pin + constant-tau dynamics (as in the parking NLP).
        c_dyn = x_next - point_step(
            x, u, torch.ones((), dtype=dt, device=w.device), spec.Ts)
        c_tau = tau - 1.0
    else:
        c_dyn = x_next - point_step(x, u, tau, spec.Ts)
        c_tau = tau_next - tau

    dist, norm_sq = obca.point_obca_terms(
        x[..., :2], lam, spec.obstacles.A, spec.obstacles.b)
    c_norm = 1.0 - norm_sq               # >= 0 (distance variant)
    c_dist = dist - spec.d_min[..., None]  # >= 0
    return torch.cat([c_bc, c_dyn, c_tau[..., None], c_norm, c_dist,
                      nlp.rate_rows(u, u_prev, spec)], dim=-1)


def all_constraints(L: NavLayout, W, spec):
    """Full constraint residual array [B, N+1, nc] (inactive rows
    included)."""
    return stage_constraints_local(
        L, W, nlp.stage_aux(L, W, spec), nlp.at_stages(spec),
        torch.arange(L.N + 1, device=W.device))


def constraint_masks(L: NavLayout, spec):
    """(active [B, N+1, nc], is_eq [nc]); norm, dist and rate rows are
    inequalities."""
    N = L.N
    dt = spec.x0.dtype
    dev = spec.x0.device
    B = spec.x0.shape[0]
    active = torch.zeros((B, N + 1, L.nc), dtype=dt, device=dev)
    active[:, 0, L.r_bc] = 1.0
    active[:, N, L.r_bc] = 1.0
    active[:, :N, L.r_dyn] = 1.0
    active[:, :N, L.i_taulink] = 1.0
    if L.fix_time:
        active[:, N, L.i_taulink] = 1.0
    obs_mask = spec.obstacles.obs_mask.to(dt)                  # [B, M]
    active[:, :, L.r_norm] = obs_mask[:, None]
    active[:, :, L.r_dist] = obs_mask[:, None]
    du_on = (spec.du_max >= 0).to(dt)
    active[:, :N, L.r_rate] = du_on[:, [0, 0, 1, 1]][:, None]

    is_eq = np.zeros((L.nc,))
    is_eq[L.r_bc] = 1.0
    is_eq[L.r_dyn] = 1.0
    is_eq[L.i_taulink] = 1.0
    return active, torch.as_tensor(is_eq, dtype=dt, device=dev)


def bound_arrays(L: NavLayout, spec):
    """Elementwise bounds on w entries, each [B, nw]: (lo, hi, has_lo,
    has_hi, pin).  Position, velocity, input and tau are boxed; real
    lam >= 0; ``pin`` marks padded lam entries."""
    dt = spec.x0.dtype
    dev = spec.x0.device
    B, nw = spec.x0.shape[0], L.nw
    lo = torch.full((B, nw), -1.0, dtype=dt, device=dev)
    hi = torch.full((B, nw), 1.0, dtype=dt, device=dev)
    has_lo = torch.zeros((B, nw), dtype=dt, device=dev)
    has_hi = torch.zeros((B, nw), dtype=dt, device=dev)
    lo[:, 0:2] = spec.xy_lo
    hi[:, 0:2] = spec.xy_hi
    lo[:, 2:4] = spec.v_lo
    hi[:, 2:4] = spec.v_hi
    has_lo[:, :4] = 1.0
    has_hi[:, :4] = 1.0
    lo[:, L.sl_u] = spec.u_lo
    hi[:, L.sl_u] = spec.u_hi
    has_lo[:, L.sl_u] = 1.0
    has_hi[:, L.sl_u] = 1.0
    lo[:, L.i_tau] = spec.tau_lo
    hi[:, L.i_tau] = spec.tau_hi
    has_lo[:, L.i_tau] = 1.0
    has_hi[:, L.i_tau] = 1.0
    fmask = spec.obstacles.face_mask.reshape(B, -1)
    lo[:, L.sl_lam] = 0.0
    has_lo[:, L.sl_lam] = fmask
    pin = torch.zeros((B, nw), dtype=dt, device=dev)
    pin[:, L.sl_lam] = 1.0 - fmask
    return lo, hi, has_lo, has_hi, pin


# ---------------------------------------------------------------------------
# Objective (the parking objective's family, without mu terms).
# ---------------------------------------------------------------------------


def objective(L: NavLayout, W, spec):
    """Per-lane objective [B]."""
    N = L.N
    B = W.shape[0]
    u = W[..., L.sl_u]
    tau = W[..., L.i_tau]
    lam = W[..., L.sl_lam]

    c_u = torch.sum(u[:, :N] ** 2 * spec.r_u[:, None, :], dim=(1, 2))
    du = torch.diff(u, dim=1, prepend=spec.u_prev[:, None, :])[:, :N] \
        / spec.Ts[:, None, None]
    c_du = torch.sum(du ** 2 * spec.r_du[:, None, :], dim=(1, 2))
    c_t = torch.sum(spec.q_time[:, :1] * tau + spec.q_time[:, 1:] * tau ** 2,
                    dim=1) / (N + 1)

    fmask = spec.obstacles.face_mask.reshape(B, -1)
    pin = (torch.sum((lam ** 2) * (1.0 - fmask)[:, None], dim=(1, 2))
           + torch.sum(u[:, N] ** 2, dim=-1))
    reg = torch.sum(((lam - spec.dual_ref) ** 2) * fmask[:, None],
                    dim=(1, 2))
    return c_u + c_du + c_t + 0.5 * PIN_KAPPA * pin + 0.5 * spec.w_reg * reg


def total_lagrangian(L: NavLayout, W, nu, spec, active):
    """Per-lane f(W) + sum_k nu_k . (active_k * c_k(W)) [B]."""
    c = all_constraints(L, W, spec) * active
    return objective(L, W, spec) + torch.sum(nu * c, dim=(1, 2))


def objective_stage_hessians(L: NavLayout, spec):
    """Analytic Hessian of the (quadratic) objective: (Hdiag
    [B, N+1, nw, nw], Ocross [B, nw, nw]), as
    ``nlp.objective_stage_hessians`` with lambda-only dual terms."""
    N, nw = L.N, L.nw
    dt = spec.x0.dtype
    dev = spec.x0.device
    B = spec.x0.shape[0]
    base = torch.zeros((B, nw, nw), dtype=dt, device=dev)
    base[:, L.i_tau, L.i_tau] += 2.0 * spec.q_time[:, 1] / (N + 1)
    pin = bound_arrays(L, spec)[4]
    dual_sel = torch.zeros((nw,), dtype=dt, device=dev)
    dual_sel[L.sl_lam] = 1.0
    base = base + torch.diag_embed(PIN_KAPPA * pin
                                   + spec.w_reg[:, None] * (dual_sel - pin))

    r_u2 = 2.0 * spec.r_u
    r_du2 = 2.0 * spec.r_du / spec.Ts[:, None] ** 2
    ks = torch.arange(N + 1, device=dev)
    in_cost = (ks < N).to(dt)[None, :, None]
    pair_prev = (ks <= N - 1).to(dt)[None, :, None]
    pair_next = (ks <= N - 2).to(dt)[None, :, None]
    dummy = (ks == N).to(dt)[None, :, None]
    d_u = (in_cost * r_u2[:, None] + (pair_prev + pair_next) * r_du2[:, None]
           + dummy * PIN_KAPPA * torch.ones((2,), dtype=dt, device=dev))
    Hdiag = base[:, None].expand(B, N + 1, nw, nw).clone()
    nlp._diagonal(Hdiag, L.sl_u).add_(d_u)

    Ocross = torch.zeros((B, nw, nw), dtype=dt, device=dev)
    nlp._diagonal(Ocross, L.sl_u).add_(-r_du2)
    return Hdiag, Ocross


# ---------------------------------------------------------------------------
# KKT assembly: the parking problem's structure with nav derivatives.
# ---------------------------------------------------------------------------


def coupling_structure(L: NavLayout):
    """The parking problem's constant-coupling sparsity."""
    return nlp.coupling_structure(L)


def coupling_values(L: NavLayout, spec):
    """The parking problem's coupling values [B, N, nnz]."""
    return nlp.coupling_values(L, spec)


def _assemble_k_rhs(L: NavLayout, W, nu, sigma_w, sigma_c, rhs_w, rhs_c,
                    spec, active, delta_w):
    """K [B, N+1, nz, nz] and rhs [B, N+1, nz], the constraint blocks by
    automatic differentiation."""
    with trace.span("nlp.constraint_blocks"):
        J, Hc = nlp.constraint_blocks(L, W, nu * active, spec,
                                      c_fn=stage_constraints_local)
    Hobj, _ = objective_stage_hessians(L, spec)
    return nlp.stage_kkt(L, J, Hc, Hobj, sigma_w, sigma_c, rhs_w, rhs_c,
                         active, delta_w)


def assemble_kkt(L: NavLayout, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec,
                 active, delta_w):
    """(K, E [B, N, nz, nz], rhs): the structure of
    ``nlp.assemble_kkt`` with nav's constraint derivatives and the
    parking problem's dense coupling."""
    K, rhs = _assemble_k_rhs(L, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec,
                             active, delta_w)
    return K, nlp.coupling_block(L, spec, active), rhs


def assemble_kkt_structured(L: NavLayout, W, nu, sigma_w, sigma_c, rhs_w,
                            rhs_c, spec, active, delta_w):
    """(K [B, N+1, nz, nz], e_vals [B, N, nnz], rhs [B, N+1, nz]); the
    dense coupling E is never built."""
    K, rhs = _assemble_k_rhs(L, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec,
                             active, delta_w)
    return K, coupling_values(L, spec), rhs


# ---------------------------------------------------------------------------
# Warm start, scenario, entry point.
# ---------------------------------------------------------------------------


def default_init(spec, dtype=None):
    """Interpolated positions, consistent velocities and a geometric
    lambda warm start (one-hot on the most-separating face, scaled into
    the strict interior of the norm inequality): W [B, N+1, nw]."""
    dt = dtype or spec.x0.dtype
    dev = spec.x0.device
    L = layout_of(spec)
    N, B = L.N, spec.x0.shape[0]
    alpha = linspace(0.0, 1.0, N + 1, dt, dev)[:, None]
    P = (1.0 - alpha) * spec.x0[:, None, :2].to(dt) \
        + alpha * spec.xF[:, None, :2].to(dt)                 # [B, N+1, 2]
    V = torch.diff(P, dim=1) / spec.Ts[:, None, None].to(dt)
    V = torch.cat([V, V[:, -1:]], dim=1)
    X = torch.cat([P, V], dim=-1)

    A = spec.obstacles.A.to(dt)                               # [B, M, V, 2]
    fm = spec.obstacles.face_mask.to(dt)[:, None]             # [B, 1, M, V]
    om = spec.obstacles.obs_mask.to(dt)[:, None, :, None]     # [B, 1, M, 1]
    face_val = (torch.einsum("bmvd,bkd->bkmv", A, P)
                - spec.obstacles.b.to(dt)[:, None])
    face_val = torch.where(fm > 0, face_val, torch.full_like(face_val, -1e9))
    i_star = torch.argmax(face_val, dim=-1)                   # [B, K, M]
    lam = one_hot(i_star, L.V, dt) * fm
    lam = (0.9 * lam + 1e-2) * fm * om

    W = torch.zeros((B, N + 1, L.nw), dtype=dt, device=dev)
    W[..., L.sl_x] = X
    W[..., L.i_tau] = 1.0
    W[..., L.sl_lam] = lam.reshape(B, N + 1, -1)
    return W


def nav_spec(x0=(-8.0, 0.0, 0.0, 0.0), xF=(8.0, 0.0, 0.0, 0.0),
             vertex_lists=None, N=60, Ts=0.25, d_min=0.2, fix_time=True,
             max_obs=4, max_faces=4, dtype=torch.float64,
             device="cuda") -> NavSpec:
    """A point-mass navigation instance.  Default scenario: two
    staggered boxes forcing an S-shaped path."""
    if vertex_lists is None:
        vertex_lists = [
            [(-4.0, -6.0), (-2.0, -6.0), (-2.0, 1.5), (-4.0, 1.5)],
            [(2.0, -1.5), (4.0, -1.5), (4.0, 6.0), (2.0, 6.0)],
        ]
    obstacles = obstacles_from_vertices(
        vertex_lists, max_obs=max_obs, max_faces=max_faces, dtype=dtype,
        device=device)
    dev = obstacles.A.device

    def f(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    return NavSpec(
        x0=f(x0), xF=f(xF), Ts=f(Ts), obstacles=obstacles,
        u_lo=f([-1.0, -1.0]), u_hi=f([1.0, 1.0]),
        v_lo=f([-3.0, -3.0]), v_hi=f([3.0, 3.0]),
        xy_lo=f([-12.0, -8.0]), xy_hi=f([12.0, 8.0]),
        du_max=f([-1.0, -1.0]),       # rate bound off by default
        u_prev=f([0.0, 0.0]),
        d_min=f(d_min),
        # Mild rate / time quadratics keep every primal variable
        # positively curved (the stage blocks need nonvanishing primal
        # pivots).
        r_u=f([0.5, 0.5]), r_du=f([0.05, 0.05]), q_time=f([0.1, 0.5]),
        w_reg=f(1e-2),
        dual_ref=torch.zeros((N + 1, max_obs * max_faces), dtype=dtype,
                             device=dev),
        tau_lo=f(0.2), tau_hi=f(3.0),
        N=N, fix_time=fix_time, max_obs=max_obs, max_faces=max_faces,
    )


def solve(spec, cfg=None, W0=None):
    """``ipm.solve_single`` with this problem module (unbatched spec;
    default configuration ``SolverConfig()``)."""
    from obca_torch import nav
    from obca_torch.solver import ipm
    from obca_torch.spec import SolverConfig

    return ipm.solve_single(spec, cfg or SolverConfig(), W0, prob=nav)
