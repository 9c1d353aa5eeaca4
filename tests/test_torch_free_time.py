"""obca_torch's free-time problem (``fix_time=False``) against obca_tpu.

In free time the horizon's time scaling tau is a variable of every
stage, linked across stages by an equality row whose coupling entry
(``nlp.coupling_values``, the tau link) is 1 instead of 0.  The NLP
layer is compared at N=20 on the JAX package's spec, rebuilt for the
port with ``obca_torch.convert.spec_from_numpy``, at the port's lattice
warm start with tau moved off 1 stage by stage (so the tau-link rows are
not zero), with multipliers and barrier terms from a numpy seed.  Then
the cold dual start and the two-phase ``solve_free_time`` are compared
end to end, in float64 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import SolverConfig, f32_solver_config
from obca_torch import nlp as tnlp
from obca_torch import spec as tspec
from obca_torch.convert import config_from_numpy, spec_from_numpy
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric, lattice
from obca_tpu import nlp as jnlp
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import SolverConfig as JSolverConfig
from obca_tpu.spec import f32_solver_config as j_f32_solver_config
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

N, TS = 20, 1.2
ATOL = 1e-10   # float64, same formulas: only rounding differs


def _to_numpy_tree(obj):
    """A JAX dataclass as a dict of numpy leaves (everything else as
    is)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_numpy_tree(v)
        elif isinstance(v, jax.Array):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)[None]


@pytest.fixture(scope="module")
def case():
    """(JAX spec, port spec [1], layout, lattice warm start W0 of the
    free-time spec with tau varied per stage, seeded inputs)."""
    jspec = j_reverse_parking_spec(N=N, Ts=TS, fix_time=False)
    spec = spec_from_numpy(_to_numpy_tree(jspec), device="cpu")
    assert not spec.fix_time
    lcfg = lattice.LatticeConfig.for_spec(spec)
    W0 = geometric.lattice_warm_start(
        spec, cfg=lcfg, field=lattice.plan_field(spec, lcfg)).numpy()
    L = jnlp.layout_of(jspec)
    rng = np.random.default_rng(0)
    W0[:, L.i_tau] = 1.0 + 0.05 * rng.standard_normal(N + 1)
    # The IPM anchors the proximal dual term at the warm-start duals.
    jspec = dataclasses.replace(jspec, dual_ref=jnp.asarray(np.concatenate(
        [W0[:, L.sl_lam], W0[:, L.sl_mu]], axis=-1)))
    tsp = tspec.stack([spec_from_numpy(_to_numpy_tree(jspec),
                                       device="cpu")])
    Np1 = L.N + 1
    inputs = dict(
        nu=rng.standard_normal((Np1, L.nc)),
        sigma_w=rng.uniform(0.0, 2.0, (Np1, L.nw)),
        sigma_c=-rng.uniform(1e-3, 1.0, (Np1, L.nc)),
        rhs_w=rng.standard_normal((Np1, L.nw)),
        rhs_c=rng.standard_normal((Np1, L.nc)),
        delta_w=np.asarray(1e-4),
    )
    return jspec, tsp, L, W0, inputs


def test_free_time_nlp_matches_jax(case):
    """Masks, bounds, constraints, objective, Lagrangian gradient, the
    analytic constraint blocks, the coupling values (tau link 1) and the
    assembled structured KKT system, all within 1e-10 in float64 (masks
    and bounds exactly)."""
    jspec, tsp, L, W0, inp = case
    Lt = tnlp.layout_of(tsp)
    assert not L.fix_time and not Lt.fix_time
    active_j, is_eq_j = jnlp.constraint_masks(L, jspec)
    active_t, is_eq_t = tnlp.constraint_masks(Lt, tsp)
    np.testing.assert_array_equal(active_t[0].numpy(), np.asarray(active_j))
    np.testing.assert_array_equal(is_eq_t.numpy(), np.asarray(is_eq_j))
    for a, b in zip(tnlp.bound_arrays(Lt, tsp), jnlp.bound_arrays(L, jspec)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))

    c_j = jax.jit(lambda W: jnlp.all_constraints(L, W, jspec))(
        jnp.asarray(W0))
    c_t = tnlp.all_constraints(Lt, _t(W0), tsp)
    np.testing.assert_allclose(c_t[0].numpy(), np.asarray(c_j), rtol=0,
                               atol=ATOL)
    # The tau-link rows are live: tau differs from stage to stage.
    assert np.abs(np.asarray(c_j)[:-1, L.i_taulink]).max() > 1e-3

    f_j = jnlp.objective(L, jnp.asarray(W0), jspec)
    f_t = tnlp.objective(Lt, _t(W0), tsp)
    np.testing.assert_allclose(f_t.numpy(), [float(f_j)], rtol=1e-12)
    g_j = jax.jit(jax.grad(lambda W, nu: jnlp.total_lagrangian(
        L, W, nu, jspec, active_j)))(jnp.asarray(W0), jnp.asarray(inp["nu"]))
    g_t = tnlp.lagrangian_gradient(Lt, _t(W0), _t(inp["nu"]), tsp, active_t)
    np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j), rtol=0,
                               atol=ATOL)

    J_j, H_j = jax.jit(lambda W, nu: jnlp.constraint_blocks_analytic(
        L, W, nu, jspec))(jnp.asarray(W0), jnp.asarray(inp["nu"]))
    J_t, H_t = tnlp.constraint_blocks_analytic(Lt, _t(W0), _t(inp["nu"]),
                                               tsp)
    np.testing.assert_allclose(J_t[0].numpy(), np.asarray(J_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(H_t[0].numpy(), np.asarray(H_j), rtol=0,
                               atol=ATOL)

    ev_j = np.asarray(jnlp.coupling_values(L, jspec))
    ev_t = tnlp.coupling_values(Lt, tsp)[0].numpy()
    np.testing.assert_allclose(ev_t, ev_j, rtol=0, atol=ATOL)
    rows, cols = tnlp.coupling_structure(Lt)
    tau_entry = [j for j, (r, c) in enumerate(zip(rows, cols))
                 if r == L.nw + L.i_taulink and c == L.i_tau]
    assert len(tau_entry) == 1 and np.all(ev_t[:, tau_entry[0]] == 1.0)

    names = ("nu", "sigma_w", "sigma_c", "rhs_w", "rhs_c")
    K_j, e_j, rhs_j = jax.jit(
        lambda W, nu, sw, sc, rw, rc, dw: jnlp.assemble_kkt_structured(
            L, W, nu, sw, sc, rw, rc, jspec, active_j, dw))(
        jnp.asarray(W0), *[jnp.asarray(inp[n]) for n in names],
        jnp.asarray(inp["delta_w"]))
    K_t, e_t, rhs_t = tnlp.assemble_kkt_structured(
        Lt, _t(W0), *[_t(inp[n]) for n in names], tsp, active_t,
        torch.tensor([float(inp["delta_w"])], dtype=torch.float64))
    for got, want in ((K_t, K_j), (e_t, e_j), (rhs_t, rhs_j)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_cold_dual_state_matches_jax(case, precision):
    """The cold dual start at the warm start, under the default float64
    configuration (within 1e-12) and under the float32 one (within 1e-6
    relative: the same float32 formulas, rounded in another order)."""
    jspec, tsp, L, W0, _ = case
    if precision == "f64":
        jcfg, cfg, tol = JSolverConfig(), SolverConfig(), 1e-12
    else:
        jcfg, cfg, tol = j_f32_solver_config(), f32_solver_config(), 1e-6
    jd = jipm.cold_dual_state(jspec, jcfg, jnp.asarray(W0))
    d = ipm.cold_dual_state(tspec.take(tsp, 0), cfg, torch.tensor(W0))
    batched = ipm.cold_dual_state(tsp, cfg, torch.tensor(W0)[None])
    for name in ("nu", "s", "zL", "zU"):
        got, want = getattr(d, name).numpy(), np.asarray(getattr(jd, name))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_array_equal(getattr(batched, name)[0].numpy(), got)


def test_solve_free_time_matches_jax(case):
    """``solve_free_time`` from the lattice warm start (tau 1) under
    ``SolverConfig(max_iter=200)`` in float64: both phases converge on
    both sides, with the same iteration counts, controls within 1e-6
    and tau within 1e-6."""
    jspec, tsp, L, _, _ = case
    jspec = j_reverse_parking_spec(N=N, Ts=TS, fix_time=False)
    spec = tspec.take(tsp, 0)
    lcfg = lattice.LatticeConfig.for_spec(spec)
    W0 = geometric.lattice_warm_start(spec, cfg=lcfg,
                                      field=lattice.plan_field(spec, lcfg))
    jcfg = JSolverConfig(max_iter=200)
    res = ipm.solve_free_time(spec, config_from_numpy(_to_numpy_tree(jcfg)),
                              W0)
    jres = jax.jit(lambda sp, w: jipm.solve_free_time(sp, jcfg, w))(
        jspec, jnp.asarray(W0.numpy()))
    assert int(res.status) == int(jres.status) == ipm.STATUS_CONVERGED
    assert int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(res.U.numpy(), np.asarray(jres.U), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(res.tau), float(jres.tau), rtol=0,
                               atol=1e-6)
    # A free time: tau moved off 1.
    assert abs(float(res.tau) - 1.0) > 1e-3
