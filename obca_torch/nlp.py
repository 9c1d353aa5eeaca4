"""Stage-structured OBCA NLP: variables, constraints, objective, KKT blocks.

Port of ``obca_tpu.nlp`` with an explicit leading batch axis B: a
trajectory is W [B, N+1, nw], multipliers nu [B, N+1, nc], and the spec
leaves carry the same leading B (see ``obca_torch.spec``).

  per-stage primal variables  w_k = [x(4), u(2), tau(1), lam(M*V), mu(4M)]
  per-stage constraints  c_k = [bc(4), dyn(4), tau-link(1), obca_eq(2M),
                                norm(M), dist(M), rate(4)]

All inter-stage couplings are linear with constant coefficients, so the
KKT system is block-tridiagonal with a constant sparse off-diagonal
block E (11 nonzeros, :func:`coupling_structure`).  The hot path's
constraint blocks are written in closed form
(:func:`constraint_blocks_analytic`; the JAX package takes the dynamics
part by forward-mode AD); :func:`constraint_blocks` differentiates one
stage's rows (:func:`stage_constraints_local`) for any problem family,
and is the reference the closed form is held against.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from obca_torch import dynamics, obca, trace
from obca_torch import spec as spec_mod
from obca_torch.geometry import EGO_G

PIN_KAPPA = 1.0  # quadratic pin strength for padded/dummy variables


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static index layout derived from the spec's static fields."""

    N: int
    M: int
    V: int
    signed: bool
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
        return slice(7 + self.M * self.V, 7 + self.M * self.V + 4 * self.M)

    @property
    def nw(self):
        return 7 + self.M * self.V + 4 * self.M

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
    def r_obca_eq(self):
        return slice(9, 9 + 2 * self.M)

    @property
    def r_norm(self):
        return slice(9 + 2 * self.M, 9 + 3 * self.M)

    @property
    def r_dist(self):
        return slice(9 + 3 * self.M, 9 + 4 * self.M)

    @property
    def r_rate(self):
        return slice(9 + 4 * self.M, 13 + 4 * self.M)

    @property
    def nc(self):
        return 13 + 4 * self.M

    @property
    def nz(self):
        return self.nw + self.nc


def layout_of(spec) -> Layout:
    return Layout(N=spec.N, M=spec.max_obs, V=spec.max_faces,
                  signed=spec.signed, fix_time=spec.fix_time)


# ---------------------------------------------------------------------------
# Constraints.
# ---------------------------------------------------------------------------


def stage_aux(L: Layout, W, spec):
    """(x_next, tau_next, u_prev) per stage from W [B, N+1, nw].  The
    stage-N x_next / tau_next are dummies (the stage-N dyn row is
    masked; tau_next = 1 makes the tau row read the fix_time pin)."""
    x = W[..., L.sl_x]
    u = W[..., L.sl_u]
    tau = W[..., L.i_tau]
    x_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    tau_next = torch.cat([tau[:, 1:], torch.ones_like(tau[:, :1])], dim=1)
    u_prev = torch.cat([spec.u_prev[:, None], u[:, :-1]], dim=1)
    return x_next, tau_next, u_prev


def stage_constraints_local(L: Layout, w, aux, spec, k):
    """Constraint rows c_k [..., nc] of stages w [..., nw] (inactive
    rows included).  ``aux`` = (x_next, tau_next, u_prev) per stage,
    ``k`` the stage index; the spec leaves, ``aux`` and ``k`` broadcast
    against w's leading axes (one stage: an unbatched spec and a 0-d k,
    the form :func:`constraint_blocks` differentiates)."""
    return _stage_rows(L, unpack_w(L, w), aux, spec, k)


def unpack_w(L: Layout, w):
    """The views (x, u, tau, lam [..., M, V], mu [..., M, 4]) of stages
    w [..., nw]."""
    lead = w.shape[:-1]
    return (w[..., L.sl_x], w[..., L.sl_u], w[..., L.i_tau],
            w[..., L.sl_lam].reshape(lead + (L.M, L.V)),
            w[..., L.sl_mu].reshape(lead + (L.M, 4)))


def pack_w(L: Layout, x, u, tau, lam, mu):
    """Stage vectors [..., nw] from their parts (the inverse of
    :func:`unpack_w`)."""
    lead = x.shape[:-1]
    return torch.cat([x, u, tau[..., None], lam.reshape(lead + (L.M * L.V,)),
                      mu.reshape(lead + (4 * L.M,))], dim=-1)


def _stage_rows(L: Layout, stage_vars, aux, spec, k):
    x, u, tau, lam, mu = stage_vars
    x_next, tau_next, u_prev = aux
    dt = x.dtype

    is0 = (k == 0).to(dt)[..., None]
    c_bc = x - (is0 * spec.x0 + (1.0 - is0) * spec.xF)

    if L.fix_time:
        # Fixed time: tau is not threaded through the dynamics and each
        # stage carries the local pin tau_k - 1 = 0 (see obca_tpu.nlp).
        c_dyn = x_next - dynamics.step(
            x, u, torch.ones((), dtype=dt, device=x.device), spec.Ts,
            spec.wheelbase)
        c_tau = tau - 1.0
    else:
        c_dyn = x_next - dynamics.step(x, u, tau, spec.Ts, spec.wheelbase)
        c_tau = tau_next - tau

    obs = spec.obstacles
    eq, dist, norm_sq = obca.obca_terms(x, lam, mu, obs.A, obs.b,
                                        spec.ego_g)
    c_obca_eq = eq.reshape(eq.shape[:-2] + (2 * L.M,))
    c_norm = norm_sq - 1.0 if L.signed else 1.0 - norm_sq
    c_dist = dist - spec.d_min[..., None]
    return torch.cat([c_bc, c_dyn, c_tau[..., None], c_obca_eq, c_norm,
                      c_dist, rate_rows(u, u_prev, spec)], dim=-1)


def rate_rows(u, u_prev, spec):
    """The input-rate rows [..., 4]: lim -/+ du per input."""
    du = u - u_prev
    lim = spec.du_max * spec.Ts[..., None]
    return torch.stack(
        [lim[..., 0] - du[..., 0], lim[..., 0] + du[..., 0],
         lim[..., 1] - du[..., 1], lim[..., 1] + du[..., 1]], dim=-1)


def at_stages(spec):
    """A batched spec with a stage axis after the batch axis on every
    tensor leaf, so that its leaves broadcast against [B, N+1, ...]."""
    return spec_mod.map_tensors(lambda t: t[:, None], spec)


def all_constraints(L: Layout, W, spec):
    """Full constraint residual array [B, N+1, nc] (inactive rows
    included; the caller applies ``active``): the stage rows of every
    stage of W [B, N+1, nw] at once."""
    # The views of W before the aux's: autograd sums dW in the reverse
    # order of the views, and the float32 iterates follow that rounding.
    stage_vars = unpack_w(L, W)
    return _stage_rows(L, stage_vars, stage_aux(L, W, spec), at_stages(spec),
                       torch.arange(L.N + 1, device=W.device))


def constraint_masks(L: Layout, spec):
    """Returns (active [B, N+1, nc] — 1.0 where the row exists at that
    stage, is_eq [nc] — 1.0 equality / 0.0 inequality)."""
    N, M = L.N, L.M
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
    active[:, :, L.r_obca_eq] = obs_mask.repeat_interleave(2, dim=-1)[
        :, None]
    active[:, :, L.r_norm] = obs_mask[:, None]
    active[:, :, L.r_dist] = obs_mask[:, None]
    du_on = (spec.du_max >= 0).to(dt)
    active[:, :N, L.r_rate] = du_on[:, [0, 0, 1, 1]][:, None]

    is_eq = np.zeros((L.nc,))
    is_eq[L.r_bc] = 1.0
    is_eq[L.r_dyn] = 1.0
    is_eq[L.i_taulink] = 1.0
    is_eq[L.r_obca_eq] = 1.0
    is_eq[L.r_norm] = 1.0 if L.signed else 0.0
    return active, torch.as_tensor(is_eq, dtype=dt, device=dev)


# ---------------------------------------------------------------------------
# Objective.
# ---------------------------------------------------------------------------


def _dual_masks(L: Layout, spec):
    fmask = spec.obstacles.face_mask.reshape(spec.x0.shape[0], -1)
    omask = spec.obstacles.obs_mask.repeat_interleave(4, dim=-1)
    return fmask, omask


def objective(L: Layout, W, spec):
    """Per-lane objective [B]: input and input-rate quadratics, the
    time penalty spread over stages, pins on padded duals and the dummy
    u_N, and the proximal dual regularization around ``dual_ref``."""
    N = L.N
    u = W[..., L.sl_u]
    tau = W[..., L.i_tau]
    lam = W[..., L.sl_lam]
    mu = W[..., L.sl_mu]

    c_u = torch.sum(u[:, :N] ** 2 * spec.r_u[:, None, :], dim=(1, 2))
    du = torch.diff(u, dim=1, prepend=spec.u_prev[:, None, :])[:, :N] \
        / spec.Ts[:, None, None]
    c_du = torch.sum(du ** 2 * spec.r_du[:, None, :], dim=(1, 2))
    c_t = torch.sum(spec.q_time[:, :1] * tau + spec.q_time[:, 1:] * tau ** 2,
                    dim=1) / (N + 1)

    fmask, omask = _dual_masks(L, spec)
    pin = (torch.sum((lam ** 2) * (1.0 - fmask)[:, None], dim=(1, 2))
           + torch.sum((mu ** 2) * (1.0 - omask)[:, None], dim=(1, 2))
           + torch.sum(u[:, N] ** 2, dim=-1))
    nlam = L.M * L.V
    ref_lam = spec.dual_ref[..., :nlam]
    ref_mu = spec.dual_ref[..., nlam:]
    reg = (torch.sum(((lam - ref_lam) ** 2) * fmask[:, None], dim=(1, 2))
           + torch.sum(((mu - ref_mu) ** 2) * omask[:, None], dim=(1, 2)))
    return c_u + c_du + c_t + 0.5 * PIN_KAPPA * pin + 0.5 * spec.w_reg * reg


def objective_gradient(L: Layout, W, spec):
    """d objective / dW [B, N+1, nw] (autograd of the per-lane sum)."""
    with torch.enable_grad():
        Wv = W.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(objective(L, Wv, spec).sum(), Wv)
    return g


def total_lagrangian(L: Layout, W, nu, spec, active):
    """Per-lane f(W) + sum_k nu_k . (active_k * c_k(W)) [B]."""
    c = all_constraints(L, W, spec) * active
    return objective(L, W, spec) + torch.sum(nu * c, dim=(1, 2))


def lagrangian_gradient(L, W, nu, spec, active, lagrangian=None):
    """d lagrangian / dW [B, N+1, nw] (autograd of the per-lane sum —
    exact, because the lanes are independent).  ``lagrangian`` is a
    problem family's ``total_lagrangian`` (default: this module's)."""
    lagrangian = lagrangian or total_lagrangian
    with torch.enable_grad():
        Wv = W.detach().requires_grad_(True)
        lag = lagrangian(L, Wv, nu, spec, active).sum()
        (g,) = torch.autograd.grad(lag, Wv)
    return g


# ---------------------------------------------------------------------------
# Bounds.
# ---------------------------------------------------------------------------


def bound_arrays(L: Layout, spec):
    """Elementwise bounds on w entries, each [B, nw]: (lo, hi, has_lo,
    has_hi, pin).  psi is free; X, Y, v, u, tau are boxed; real lam/mu
    >= 0; ``pin`` marks padded dual entries (quadratic pin, no barrier)."""
    dt = spec.x0.dtype
    dev = spec.x0.device
    B, nw = spec.x0.shape[0], L.nw
    lo = torch.full((B, nw), -1.0, dtype=dt, device=dev)
    hi = torch.full((B, nw), 1.0, dtype=dt, device=dev)
    has_lo = torch.zeros((B, nw), dtype=dt, device=dev)
    has_hi = torch.zeros((B, nw), dtype=dt, device=dev)
    lo[:, 0:2] = spec.xy_lo
    hi[:, 0:2] = spec.xy_hi
    lo[:, 3] = spec.v_lo
    hi[:, 3] = spec.v_hi
    lo[:, L.sl_u] = spec.u_lo
    hi[:, L.sl_u] = spec.u_hi
    lo[:, L.i_tau] = spec.tau_lo
    hi[:, L.i_tau] = spec.tau_hi
    for i in (0, 1, 3, 4, 5, L.i_tau):
        has_lo[:, i] = 1.0
        has_hi[:, i] = 1.0
    fmask, omask = _dual_masks(L, spec)
    lo[:, L.sl_lam] = 0.0
    lo[:, L.sl_mu] = 0.0
    has_lo[:, L.sl_lam] = fmask
    has_lo[:, L.sl_mu] = omask
    pin = torch.zeros((B, nw), dtype=dt, device=dev)
    pin[:, L.sl_lam] = 1.0 - fmask
    pin[:, L.sl_mu] = 1.0 - omask
    return lo, hi, has_lo, has_hi, pin


# ---------------------------------------------------------------------------
# KKT block assembly.
# ---------------------------------------------------------------------------


def objective_stage_hessians(L: Layout, spec):
    """Analytic Hessian of the (quadratic) objective: (Hdiag
    [B, N+1, nw, nw], Ocross [B, nw, nw]) — stage-diagonal blocks and
    the constant u_k / u_{k+1} cross block of the rate cost."""
    N, nw = L.N, L.nw
    dt = spec.x0.dtype
    dev = spec.x0.device
    B = spec.x0.shape[0]
    base = torch.zeros((B, nw, nw), dtype=dt, device=dev)
    base[:, L.i_tau, L.i_tau] += 2.0 * spec.q_time[:, 1] / (N + 1)
    pin = bound_arrays(L, spec)[4]
    dual_sel = torch.zeros((nw,), dtype=dt, device=dev)
    dual_sel[L.sl_lam] = 1.0
    dual_sel[L.sl_mu] = 1.0
    base = base + torch.diag_embed(PIN_KAPPA * pin
                                   + spec.w_reg[:, None] * (dual_sel - pin))

    r_u2 = 2.0 * spec.r_u                                     # [B, 2]
    r_du2 = 2.0 * spec.r_du / spec.Ts[:, None] ** 2
    ks = torch.arange(N + 1, device=dev)
    in_cost = (ks < N).to(dt)[None, :, None]
    pair_prev = (ks <= N - 1).to(dt)[None, :, None]
    pair_next = (ks <= N - 2).to(dt)[None, :, None]
    dummy = (ks == N).to(dt)[None, :, None]
    d_u = (in_cost * r_u2[:, None] + (pair_prev + pair_next) * r_du2[:, None]
           + dummy * PIN_KAPPA * torch.ones((2,), dtype=dt, device=dev))
    Hdiag = base[:, None].expand(B, N + 1, nw, nw).clone()
    _diagonal(Hdiag, L.sl_u).add_(d_u)

    Ocross = torch.zeros((B, nw, nw), dtype=dt, device=dev)
    _diagonal(Ocross, L.sl_u).add_(-r_du2)
    return Hdiag, Ocross


def _diagonal(a, sl):
    """The diagonal of a[..., sl, sl] (a view)."""
    return a[..., sl, sl].diagonal(dim1=-2, dim2=-1)


def coupling_structure(L: Layout):
    """Static sparsity (rows [nnz], cols [nnz]) of the constant
    off-diagonal block E: dynamics identity (4), free-time tau link
    (1), rate rows (4), rate-cost cross term (2)."""
    nw = L.nw
    rows, cols = [], []
    for i in range(4):
        rows.append(nw + L.r_dyn.start + i)
        cols.append(i)
    rows.append(nw + L.i_taulink)
    cols.append(L.i_tau)
    iu = [L.sl_u.start, L.sl_u.start + 1]
    rate_in = [0, 0, 1, 1]
    for j in range(4):
        rows.append(iu[rate_in[j]])
        cols.append(nw + L.r_rate.start + j)
    for i in range(2):
        rows.append(iu[i])
        cols.append(iu[i])
    return np.asarray(rows), np.asarray(cols)


def coupling_block(L: Layout, spec, active):
    """The constant off-diagonal KKT blocks E_k = T[zeta_k, zeta_{k+1}]
    as dense [B, N, nz, nz]: :func:`coupling_values` at
    :func:`coupling_structure`'s positions (tests and the dense-coupling
    solver; the hot path never builds it).  ``active`` is unused, as in
    the JAX package."""
    rows, cols = coupling_structure(L)
    vals = coupling_values(L, spec)
    E = vals.new_zeros(vals.shape[:2] + (L.nz, L.nz))
    E[:, :, rows, cols] = vals
    return E


def coupling_values(L: Layout, spec):
    """Values of E at :func:`coupling_structure` positions [B, N, nnz];
    stage N-1 keeps only the dynamics / tau entries."""
    dt = spec.x0.dtype
    dev = spec.x0.device
    B = spec.x0.shape[0]
    du_on = (spec.du_max >= 0).to(dt)
    consts = _consts(dt, dev)
    r_du2 = 2.0 * spec.r_du / spec.Ts[:, None] ** 2
    tau_link = torch.zeros if L.fix_time else torch.ones
    vals = torch.cat([
        torch.ones((B, 4), dtype=dt, device=dev),
        tau_link((B, 1), dtype=dt, device=dev),
        consts["rate_sign_e"] * du_on[:, consts["rate_in"]],
        -r_du2,
    ], dim=-1)
    ks = torch.arange(L.N, device=dev)
    last = (ks == L.N - 1).to(dt)[:, None]
    edge = torch.cat([torch.ones((5,), dtype=dt, device=dev),
                      torch.zeros((6,), dtype=dt, device=dev)])
    return vals[:, None, :] * (1.0 - last * (1.0 - edge[None, :]))[None]


def _sym(a, b):
    """a b' + b a' for [..., 7] vectors."""
    return a[..., :, None] * b[..., None, :] + b[..., :, None] * a[..., None, :]


def _dynamics_derivatives(L: Layout, z, nu4, Ts, wb):
    """Closed-form Jacobian [..., 4, 7] of f(z) = dynamics.step over
    z = (X, Y, psi, v, delta, a, tau) and the nu4-weighted Hessian
    sum_i nu4_i d2 f_i [..., 7, 7].  Fixed time uses tau = 1 (no tau
    dependence)."""
    dt, dev = z.dtype, z.device
    E = torch.eye(7, dtype=dt, device=dev)
    psi, v, delta, a, tau = (z[..., 2], z[..., 3], z[..., 4], z[..., 5],
                             z[..., 6])
    if L.fix_time:
        h = torch.ones((), dtype=dt, device=dev) * Ts
        dh = torch.zeros(z.shape, dtype=dt, device=dev)
    else:
        h = tau * Ts
        dh = Ts[..., None] * E[6]
    h = h.expand_as(psi)
    tn = torch.tan(delta)
    k = tn / wb
    kd = (1.0 + tn * tn) / wb
    dk = kd[..., None] * E[4]
    ddk = (2.0 * tn * kd)[..., None, None] * (E[4][:, None] * E[4][None, :])

    vm = v + 0.5 * h * a
    dvm = E[3] + 0.5 * (dh * a[..., None] + h[..., None] * E[5])
    ddvm = 0.5 * _sym(dh, E[5].expand_as(dh))
    pm = psi + 0.5 * h * v * k
    dpm = E[2] + 0.5 * (dh * (v * k)[..., None] + (h * k)[..., None] * E[3]
                        + (h * v)[..., None] * dk)
    ev3 = E[3].expand_as(dh)
    ddpm = 0.5 * ((h * v)[..., None, None] * ddk
                  + k[..., None, None] * _sym(dh, ev3)
                  + v[..., None, None] * _sym(dh, dk)
                  + h[..., None, None] * _sym(ev3, dk))
    P = h * vm
    dP = dh * vm[..., None] + h[..., None] * dvm
    ddP = _sym(dh, dvm) + h[..., None, None] * ddvm
    c, s = torch.cos(pm), torch.sin(pm)

    Jf = torch.stack([
        E[0] + dP * c[..., None] - (P * s)[..., None] * dpm,
        E[1] + dP * s[..., None] + (P * c)[..., None] * dpm,
        E[2] + dP * k[..., None] + P[..., None] * dk,
        E[3] + dh * a[..., None] + h[..., None] * E[5],
    ], dim=-2)

    c2, s2, k2, P2 = (t[..., None, None] for t in (c, s, k, P))
    o_pm = dpm[..., :, None] * dpm[..., None, :]
    s_Ppm = _sym(dP, dpm)
    H0 = ddP * c2 - s2 * s_Ppm - P2 * (c2 * o_pm + s2 * ddpm)
    H1 = ddP * s2 + c2 * s_Ppm + P2 * (-s2 * o_pm + c2 * ddpm)
    H2 = ddP * k2 + _sym(dP, dk) + P2 * ddk
    H3 = _sym(dh, E[5].expand_as(dh))
    n = nu4[..., None, None]
    H = n[..., 0, :, :] * H0 + n[..., 1, :, :] * H1 \
        + n[..., 2, :, :] * H2 + n[..., 3, :, :] * H3
    return Jf, H


@functools.lru_cache(maxsize=None)
def _block_index(L: Layout, device):
    """The index arrays of the closed-form constraint blocks as int64
    tensors on ``device``, built once per layout and device so that an
    iteration builds no tensor from host data."""
    M, V = L.M, L.V
    eq0, lam0, mu0 = L.r_obca_eq.start, L.sl_lam.start, L.sl_mu.start
    iu = np.arange(L.sl_u.start, L.sl_u.stop)
    rows2 = eq0 + 2 * np.arange(M)[:, None, None] + np.arange(2)[None, :, None]
    cn = lam0 + V * np.arange(M)[:, None] + np.arange(V)[None, :]
    cmu = mu0 + 4 * np.arange(M)[:, None] + np.arange(4)[None, :]
    rd = L.r_dist.start + np.arange(M)
    ix = dict(
        eq_lam=np.broadcast_arrays(rows2, cn[:, None, :]),       # [M, 2, V]
        eq_mu=np.broadcast_arrays(rows2, cmu[:, None, :]),       # [M, 2, 4]
        nrm_lam=np.broadcast_arrays((L.r_norm.start + np.arange(M))[:, None],
                                    cn),
        dst=rd,
        dst_lam=np.broadcast_arrays(rd[:, None], cn),
        dst_mu=np.broadcast_arrays(rd[:, None], cmu),
        rate=(L.r_rate.start + np.arange(4), iu[np.array([0, 0, 1, 1])]),
        lam_cols=lam0 + np.arange(M * V),
        lam_lam=np.broadcast_arrays(cn[:, :, None], cn[:, None, :]),
    )

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device)

    return {k: tuple(tensor(a) for a in v) if isinstance(v, (tuple, list))
            else tensor(v) for k, v in ix.items()}


@functools.lru_cache(maxsize=None)
def _consts(dtype, device):
    """The constant values of the blocks in ``dtype`` on ``device``
    (built once): the ego box's G, the rate rows' signs in J and in the
    coupling values, and the input each rate row bounds."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(G=t(EGO_G), rate_sign_j=t([-1.0, 1.0, -1.0, 1.0]),
                rate_sign_e=t([1.0, -1.0, 1.0, -1.0]),
                rate_in=torch.as_tensor([0, 0, 1, 1], device=device))


def constraint_blocks_analytic(L: Layout, W, nu, spec):
    """Per-stage constraint Jacobians J [B, N+1, nc, nw] and the
    nu-weighted constraint Hessians Hc [B, N+1, nw, nw], closed form."""
    B, Np1, nw, nc = W.shape[0], L.N + 1, L.nw, L.nc
    M, V = L.M, L.V
    dt, dev = W.dtype, W.device
    ix = _block_index(L, dev)
    consts = _consts(dt, dev)
    x = W[..., L.sl_x]
    lam = W[..., L.sl_lam].reshape(B, Np1, M, V)
    psi = x[..., 2]
    t = x[..., :2]
    A = spec.obstacles.A                                     # [B, M, V, 2]
    b = spec.obstacles.b
    G = consts["G"]                                          # [4, 2]
    sgn = 1.0 if L.signed else -1.0

    cth, sth = torch.cos(psi), torch.sin(psi)
    R = torch.stack([torch.stack([cth, -sth], -1),
                     torch.stack([sth, cth], -1)], -2)       # [B, K, 2, 2]
    R_p = torch.stack([torch.stack([-sth, -cth], -1),
                       torch.stack([cth, -sth], -1)], -2)

    s = torch.einsum("bmvd,bkmv->bkmd", A, lam)               # A'lam
    Rt_s = torch.einsum("bkde,bkmd->bkme", R, s)
    Rpt_s = torch.einsum("bkde,bkmd->bkme", R_p, s)
    Rt_A = torch.einsum("bkde,bmvd->bkmve", R, A)
    Rpt_A = torch.einsum("bkde,bmvd->bkmve", R_p, A)

    # ---- Jacobian ----
    J = torch.zeros((B, Np1, nc, nw), dtype=dt, device=dev)
    _diagonal(J, L.r_bc).fill_(1.0)

    nu_dyn = nu[..., L.r_dyn]
    Jf, H7 = _dynamics_derivatives(L, W[..., :7], nu_dyn,
                                   spec.Ts[:, None], spec.wheelbase[:, None])
    J[:, :, L.r_dyn, :7] = -Jf
    J[:, :, L.i_taulink, L.i_tau] = 1.0 if L.fix_time else -1.0

    eq0 = L.r_obca_eq.start
    J[:, :, eq0:eq0 + 2 * M, 2] = Rpt_s.reshape(B, Np1, 2 * M)
    J[:, :, ix["eq_lam"][0], ix["eq_lam"][1]] = Rt_A.transpose(-1, -2)
    J[:, :, ix["eq_mu"][0], ix["eq_mu"][1]] = G.T

    J[:, :, ix["nrm_lam"][0], ix["nrm_lam"][1]] = sgn * 2.0 * torch.einsum(
        "bmvd,bkmd->bkmv", A, s)
    J[:, :, ix["dst"], 0] = s[..., 0]
    J[:, :, ix["dst"], 1] = s[..., 1]
    face_val = torch.einsum("bmvd,bkd->bkmv", A, t) - b[:, None]
    J[:, :, ix["dst_lam"][0], ix["dst_lam"][1]] = face_val
    J[:, :, ix["dst_mu"][0], ix["dst_mu"][1]] = -spec.ego_g[:, None, None, :]
    J[:, :, ix["rate"][0], ix["rate"][1]] = consts["rate_sign_j"]

    # ---- nu-weighted constraint Hessian ----
    nu_eq = nu[..., L.r_obca_eq].reshape(B, Np1, M, 2)
    nu_nrm = nu[..., L.r_norm]
    nu_dst = nu[..., L.r_dist]
    Hc = torch.zeros((B, Np1, nw, nw), dtype=dt, device=dev)
    Hc[..., :7, :7] = -H7
    Hc[..., 2, 2] += -torch.einsum("bkmd,bkmd->bk", nu_eq, Rt_s)
    flat = torch.einsum("bkmd,bkmvd->bkmv", nu_eq, Rpt_A).reshape(
        B, Np1, M * V)
    lam_cols = ix["lam_cols"]
    Hc[..., 2, lam_cols] += flat
    Hc[..., lam_cols, 2] += flat
    AAt = torch.einsum("bmvd,bmwd->bmvw", A, A)
    h_ll = 2.0 * sgn * nu_nrm[..., None, None] * AAt[:, None]
    Hc[:, :, ix["lam_lam"][0], ix["lam_lam"][1]] += h_ll
    h_tl = nu_dst[..., None, None] * A[:, None]               # [B,K,M,V,2]
    for d in range(2):
        h_d = h_tl[..., d].reshape(B, Np1, M * V)
        Hc[..., d, lam_cols] += h_d
        Hc[..., lam_cols, d] += h_d
    return J, Hc


def constraint_blocks(L, W, nu, spec, c_fn=None):
    """Per-stage constraint Jacobians J [B, N+1, nc, nw] and
    nu-weighted constraint Hessians Hc [B, N+1, nw, nw] by automatic
    differentiation of one stage, ``torch.func.vmap``-ed over the
    B * (N+1) stages; the stage aux (x_next, tau_next, u_prev) is held
    constant.  ``c_fn(L, w, aux, spec, k)`` defaults to
    :func:`stage_constraints_local`; another problem family passes its
    own.  The reference for :func:`constraint_blocks_analytic`."""
    c_fn = c_fn or stage_constraints_local
    B, Np1 = W.shape[0], L.N + 1

    def flat(t):
        return t.reshape((B * Np1,) + t.shape[2:])

    leaves = spec_mod.tensor_leaves(spec_mod.map_tensors(
        lambda t: t.repeat_interleave(Np1, dim=0), spec))
    ks = torch.arange(Np1, device=W.device).repeat(B)
    aux = [flat(a) for a in stage_aux(L, W, spec)]

    def c_local(w, xn, tn, up, k, *lv):
        return c_fn(L, w, (xn, tn, up), spec_mod.with_leaves(spec, lv), k)

    def hess_one(w, nu_k, *rest):
        return torch.func.hessian(
            lambda ww: torch.dot(nu_k, c_local(ww, *rest)))(w)

    J = torch.func.vmap(torch.func.jacfwd(c_local))(flat(W), *aux, ks,
                                                    *leaves)
    Hc = torch.func.vmap(hess_one)(flat(W), flat(nu), *aux, ks, *leaves)
    return (J.reshape(B, Np1, L.nc, L.nw),
            Hc.reshape(B, Np1, L.nw, L.nw))


def stage_kkt(L, J, Hc, Hobj, sigma_w, sigma_c, rhs_w, rhs_c, active,
              delta_w):
    """The stage KKT blocks K [B, N+1, nz, nz] and rhs [B, N+1, nz] from
    the constraint blocks (J, Hc), the objective Hessian blocks, the
    barrier diagonals and the per-lane primal regularization."""
    Jm = J * active[..., None]
    H = Hobj + Hc + torch.diag_embed(sigma_w)
    H = H + delta_w[:, None, None, None] * torch.eye(
        L.nw, dtype=J.dtype, device=J.device)
    top = torch.cat([H, Jm.transpose(-1, -2)], dim=-1)
    bot = torch.cat([Jm, torch.diag_embed(sigma_c)], dim=-1)
    K = torch.cat([top, bot], dim=-2)
    rhs = torch.cat([rhs_w, rhs_c], dim=-1)
    return K, rhs


def _assemble_k_rhs(L: Layout, W, nu, sigma_w, sigma_c, rhs_w, rhs_c,
                    spec, active, delta_w):
    """Diagonal blocks K [B, N+1, nz, nz] and rhs [B, N+1, nz] (shared by
    the dense and structured assemblers)."""
    with trace.span("nlp.constraint_blocks"):
        J, Hc = constraint_blocks_analytic(L, W, nu * active, spec)
    Hobj, _ = objective_stage_hessians(L, spec)
    return stage_kkt(L, J, Hc, Hobj, sigma_w, sigma_c, rhs_w, rhs_c, active,
                     delta_w)


def assemble_kkt(L: Layout, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec,
                 active, delta_w):
    """The KKT blocks with the dense coupling: (K [B, N+1, nz, nz], E
    [B, N, nz, nz], rhs [B, N+1, nz]).  W [B, N+1, nw] and nu
    [B, N+1, nc] the iterate, sigma_w / sigma_c the barrier diagonals
    (sigma_c negative: -delta_c on equalities, -(s/y) - delta_c on
    inequalities, -1 on masked rows), rhs_w / rhs_c the negative dual
    and primal residuals, ``delta_w`` the per-lane primal
    regularization [B]."""
    K, rhs = _assemble_k_rhs(L, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec,
                             active, delta_w)
    return K, coupling_block(L, spec, active), rhs


def assemble_kkt_structured(L: Layout, W, nu, sigma_w, sigma_c, rhs_w,
                            rhs_c, spec, active, delta_w):
    """Hot-path KKT assembly: (K [B, N+1, nz, nz], e_vals [B, N, nnz],
    rhs [B, N+1, nz]); the dense coupling E is never built."""
    K, rhs = _assemble_k_rhs(L, W, nu, sigma_w, sigma_c, rhs_w, rhs_c, spec,
                             active, delta_w)
    return K, coupling_values(L, spec), rhs


def default_init(spec, dtype=None):
    """Cold-start warm start: interpolated states + geometric duals."""
    from obca_torch.warmstart import geometric

    return geometric.warm_start(spec, dtype=dtype)
