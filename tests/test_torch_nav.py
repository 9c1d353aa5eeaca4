"""obca_torch's point-mass navigation family against obca_tpu.nav.

The JAX package's grazing two-box scenario (``tests/test_nav.py``) is
rebuilt for the port with ``obca_torch.convert.nav_spec_from_numpy``.
At N=10 every nav function is compared at the JAX package's default
warm start, moved off it by a numpy seed (so that every constraint row
is live), with multipliers and barrier terms from the same seed: the
layout, masks and bounds exactly, the rest within 1e-10 in float64 (the
same formulas, rounded in another order).  Then the AD constraint
blocks (``nlp.constraint_blocks``) are held against the closed-form
parking blocks, and the solver end to end: ``nav.solve`` at N=40 and a
3-lane ``ipm.solve_batch(..., prob=nav)`` against the JAX package's
solves, in float64 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import SolverConfig, nav, nlp, obca, reverse_parking_spec
from obca_torch import spec as tspec
from obca_torch.convert import config_from_numpy, nav_spec_from_numpy
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric
from obca_tpu import nav as jnav
from obca_tpu import nlp as jnlp
from obca_tpu import obca as jobca
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import SolverConfig as JSolverConfig
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

ATOL = 1e-10
# tests/test_nav.py's grazing layout: boxes offset from the straight
# start-goal line.
VERTS = [
    [(-4.0, 0.5), (-2.0, 0.5), (-2.0, 5.0), (-4.0, 5.0)],
    [(2.0, -5.0), (4.0, -5.0), (4.0, -0.5), (2.0, -0.5)],
]


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


def _port_spec(jspec):
    return nav_spec_from_numpy(_to_numpy_tree(jspec), device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)[None]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def case():
    """(JAX spec with dual_ref at the warm start, port spec [1], layout,
    perturbed warm start W0, seeded inputs)."""
    jspec = jnav.nav_spec(N=10, vertex_lists=VERTS)
    L = jnav.layout_of(jspec)
    rng = np.random.default_rng(0)
    W0 = np.asarray(jax.jit(jnav.default_init)(jspec))
    W0 = W0 + 0.05 * rng.standard_normal(W0.shape)
    jspec = dataclasses.replace(jspec, dual_ref=jnp.asarray(W0[:, L.sl_lam]))
    tsp = tspec.stack([_port_spec(jspec)])
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


def test_nav_layout_masks_bounds_match_jax(case):
    jspec, tsp, L, _, _ = case
    Lt = nav.layout_of(tsp)
    for name in ("nw", "nc", "nz", "sl_x", "sl_u", "i_tau", "sl_lam",
                 "sl_mu", "r_bc", "r_dyn", "i_taulink", "r_norm", "r_dist",
                 "r_rate"):
        assert getattr(Lt, name) == getattr(L, name), name
    active_j, is_eq_j = jnav.constraint_masks(L, jspec)
    active_t, is_eq_t = nav.constraint_masks(Lt, tsp)
    np.testing.assert_array_equal(active_t[0].numpy(), np.asarray(active_j))
    np.testing.assert_array_equal(is_eq_t.numpy(), np.asarray(is_eq_j))
    for a, b in zip(nav.bound_arrays(Lt, tsp), jnav.bound_arrays(L, jspec)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    rows_t, cols_t = nav.coupling_structure(Lt)
    rows_j, cols_j = jnav.coupling_structure(L)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(cols_t, cols_j)
    _close(nav.coupling_values(Lt, tsp)[0],
           jnlp.coupling_values(L, jspec))


def test_nav_dynamics_and_obca_terms_match_jax(case):
    """point_step and rollout (fixed and free time) and
    point_obca_terms, batched, against the JAX functions per lane."""
    jspec, tsp, L, W0, _ = case
    rng = np.random.default_rng(1)
    U = rng.uniform(-0.5, 0.5, (3, L.N, 2))
    x0 = rng.standard_normal((3, 4))
    tau = np.asarray([1.0, 0.8, 1.3])
    X = nav.rollout(torch.tensor(x0), torch.tensor(U), torch.tensor(tau),
                    tsp.Ts)
    roll = jax.jit(jnav.rollout)
    for i in range(3):
        _close(X[i], roll(jnp.asarray(x0[i]), jnp.asarray(U[i]),
                          jnp.asarray(tau[i]), jspec.Ts))

    lam = rng.uniform(0.0, 1.0, (L.N + 1, L.M, L.V))
    P = W0[:, :2]
    dist_t, nsq_t = obca.point_obca_terms(
        torch.tensor(P), torch.tensor(lam), tsp.obstacles.A[:, None],
        tsp.obstacles.b[:, None])
    terms = jax.jit(jax.vmap(jobca.point_obca_terms,
                             in_axes=(0, 0, None, None)))
    dist_j, nsq_j = terms(jnp.asarray(P), jnp.asarray(lam),
                          jspec.obstacles.A, jspec.obstacles.b)
    _close(dist_t[0], dist_j)
    _close(nsq_t[0], nsq_j)


def test_nav_constraints_objective_gradient_match_jax(case):
    jspec, tsp, L, W0, inp = case
    Lt = nav.layout_of(tsp)
    active_j, _ = jnav.constraint_masks(L, jspec)
    active_t, _ = nav.constraint_masks(Lt, tsp)
    c_j = jax.jit(lambda W: jnav.all_constraints(L, W, jspec))(
        jnp.asarray(W0))
    c_t = nav.all_constraints(Lt, _t(W0), tsp)
    _close(c_t[0], c_j)
    # Every row kind is live at the perturbed start.
    assert np.abs(np.asarray(c_j)[:-1, L.r_dyn]).min() > 1e-6
    f_j = jax.jit(lambda W: jnav.objective(L, W, jspec))(jnp.asarray(W0))
    f_t = nav.objective(Lt, _t(W0), tsp)
    np.testing.assert_allclose(f_t.numpy(), [float(f_j)], rtol=1e-12)
    lag_j = jax.jit(lambda W, nu: jnav.total_lagrangian(
        L, W, nu, jspec, active_j))(jnp.asarray(W0), jnp.asarray(inp["nu"]))
    lag_t = nav.total_lagrangian(Lt, _t(W0), _t(inp["nu"]), tsp, active_t)
    np.testing.assert_allclose(lag_t.numpy(), [float(lag_j)], rtol=1e-12)
    g_j = jax.jit(jax.grad(lambda W, nu: jnav.total_lagrangian(
        L, W, nu, jspec, active_j)))(jnp.asarray(W0), jnp.asarray(inp["nu"]))
    g_t = nlp.lagrangian_gradient(Lt, _t(W0), _t(inp["nu"]), tsp, active_t,
                                  nav.total_lagrangian)
    _close(g_t[0], g_j)


def test_nav_constraint_blocks_and_kkt_match_jax(case):
    """J and Hc from ``nlp.constraint_blocks`` with the nav stage rows,
    the objective Hessian blocks and the structured KKT assembly."""
    jspec, tsp, L, W0, inp = case
    Lt = nav.layout_of(tsp)
    J_j, H_j = jax.jit(lambda W, nu: jnlp.constraint_blocks(
        L, W, nu, jspec, c_fn=jnav.stage_constraints_local))(
        jnp.asarray(W0), jnp.asarray(inp["nu"]))
    J_t, H_t = nlp.constraint_blocks(Lt, _t(W0), _t(inp["nu"]), tsp,
                                     c_fn=nav.stage_constraints_local)
    _close(J_t[0], J_j)
    _close(H_t[0], H_j)
    Hd_j, Oc_j = jnav.objective_stage_hessians(L, jspec)
    Hd_t, Oc_t = nav.objective_stage_hessians(Lt, tsp)
    _close(Hd_t[0], Hd_j)
    _close(Oc_t[0], Oc_j)

    active_j, _ = jnav.constraint_masks(L, jspec)
    active_t, _ = nav.constraint_masks(Lt, tsp)
    names = ("nu", "sigma_w", "sigma_c", "rhs_w", "rhs_c")
    K_j, e_j, rhs_j = jax.jit(
        lambda W, nu, sw, sc, rw, rc, dw: jnav.assemble_kkt_structured(
            L, W, nu, sw, sc, rw, rc, jspec, active_j, dw))(
        jnp.asarray(W0), *[jnp.asarray(inp[n]) for n in names],
        jnp.asarray(inp["delta_w"]))
    K_t, e_t, rhs_t = nav.assemble_kkt_structured(
        Lt, _t(W0), *[_t(inp[n]) for n in names], tsp, active_t,
        torch.tensor([float(inp["delta_w"])], dtype=torch.float64))
    for got, want in ((K_t, K_j), (e_t, e_j), (rhs_t, rhs_j)):
        _close(got[0], want)


def test_nav_default_init_and_spec_match_jax():
    """``nav_spec`` builds the JAX package's spec, and ``default_init``
    its warm start (default scenario, N=10)."""
    jspec = jnav.nav_spec(N=10)
    spec = nav.nav_spec(N=10, device="cpu")
    jt = _to_numpy_tree(jspec)
    for f in dataclasses.fields(spec):
        got = getattr(spec, f.name)
        if f.name == "obstacles":
            for g in dataclasses.fields(got):
                v = getattr(got, g.name)
                want = jt["obstacles"][g.name]
                if isinstance(v, torch.Tensor):
                    np.testing.assert_array_equal(v.numpy(), want)
                else:
                    assert v == want, g.name
        elif isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), jt[f.name])
        else:
            assert got == jt[f.name], f.name
    W_j = jax.jit(jnav.default_init)(jspec)
    W_t = nav.default_init(tspec.stack([spec]))
    _close(W_t[0], W_j, atol=1e-12)


@pytest.mark.parametrize("signed", [True, False])
def test_constraint_blocks_ad_matches_analytic(signed):
    """The AD blocks of the parking problem (``nlp.constraint_blocks``,
    its default stage rows) against the closed-form
    ``constraint_blocks_analytic`` at N=10 (2 lanes, a perturbed lattice
    start, seeded multipliers), and against the JAX package's
    ``nlp.constraint_blocks`` on lane 0."""
    base = reverse_parking_spec(N=10, Ts=2.4, signed=signed, device="cpu")
    specs = tspec.stack([base, dataclasses.replace(
        base, x0=base.x0 + torch.tensor([0.3, -0.2, 0.0, 0.0],
                                        dtype=torch.float64))])
    L = nlp.layout_of(specs)
    rng = np.random.default_rng(2)
    W = geometric.warm_start(specs)
    W = W + 0.05 * torch.tensor(rng.standard_normal(tuple(W.shape)))
    nu = torch.tensor(rng.standard_normal((2, L.N + 1, L.nc)))
    J_ad, H_ad = nlp.constraint_blocks(L, W, nu, specs)
    J_an, H_an = nlp.constraint_blocks_analytic(L, W, nu, specs)
    _close(J_ad, J_an, atol=1e-12)
    _close(H_ad, H_an, atol=1e-12)

    jspec = j_reverse_parking_spec(N=10, Ts=2.4, signed=signed)
    Lj = jnlp.layout_of(jspec)
    J_j, H_j = jax.jit(lambda W, nu: jnlp.constraint_blocks(
        Lj, W, nu, jspec))(jnp.asarray(W[0].numpy()),
                          jnp.asarray(nu[0].numpy()))
    _close(J_ad[0], J_j)
    _close(H_ad[0], H_j)


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX package's nav solve, jitted once for N=40:
    ``nav.solve(spec, SolverConfig(max_iter=150))``."""
    jcfg = JSolverConfig(max_iter=150)
    return jcfg, jax.jit(lambda sp: jipm.solve_single(sp, jcfg, prob=jnav))


def test_nav_solve_matches_jax(jax_solve):
    """``nav.solve`` at N=40 on the grazing layout: the same status and
    iterations as the JAX package's, controls within 1e-6, boundary
    conditions within 1e-5, and every stage point at least d_min - 1e-4
    outside every obstacle."""
    jcfg, jsolve = jax_solve
    jspec = jnav.nav_spec(N=40, vertex_lists=VERTS)
    spec = _port_spec(jspec)
    res = nav.solve(spec, config_from_numpy(_to_numpy_tree(jcfg)))
    jres = jsolve(jspec)
    assert int(res.status) == int(jres.status) == ipm.STATUS_CONVERGED
    assert int(res.iters) == int(jres.iters)
    _close(res.U, jres.U, atol=1e-6)
    _close(res.X[0], spec.x0, atol=1e-5)
    _close(res.X[-1], spec.xF, atol=1e-5)
    P = res.X[:, :2].numpy()
    A = spec.obstacles.A.numpy()
    b = spec.obstacles.b.numpy()
    for m in np.flatnonzero(spec.obstacles.obs_mask.numpy()):
        margin = np.max(P @ A[m].T - b[m], axis=1)
        assert margin.min() >= float(spec.d_min) - 1e-4


def test_nav_solve_batch_matches_jax(jax_solve):
    """A 3-lane ``ipm.solve_batch(..., prob=nav)`` (start y shifted by
    -0.4, -0.2, 0.2, as ``test_nav_batch_vmap``) at N=40 against the JAX
    package's solve of each lane: status, iterations and controls within
    1e-6."""
    jcfg, jsolve = jax_solve
    base = jnav.nav_spec(N=40, vertex_lists=VERTS)
    jspecs = [dataclasses.replace(base, x0=base.x0.at[1].add(dy))
              for dy in (-0.4, -0.2, 0.2)]
    specs = tspec.stack([_port_spec(s) for s in jspecs])
    res = ipm.solve_batch(specs, config_from_numpy(_to_numpy_tree(jcfg)),
                          prob=nav)
    assert res.U.shape == (3, 40, 2)
    for i, js in enumerate(jspecs):
        jres = jsolve(js)
        assert int(res.status[i]) == int(jres.status) == ipm.STATUS_CONVERGED
        assert int(res.iters[i]) == int(jres.iters)
        _close(res.U[i], jres.U, atol=1e-6)


def test_nav_rescue_and_cold_duals():
    """The rescue path with ``prob=nav`` against the JAX package's on
    the same 3-lane batch (N=24): under a cap that one lane of three
    misses, pass 1 leaves it unconverged, the rescue round seeds it from
    its nearest converged neighbour (``donor_features`` reads the nav
    obstacles) and it converges, with the same statuses and iterations
    as ``jipm.solve_batch_rescued(..., prob=jnav)`` and controls within
    1e-6 (one rescue round on both sides: the batch is clean after it,
    so a second round would be skipped by both); then ``cold_dual_state(..., prob=nav)`` (its dual_ref has no
    mu block) against the JAX package's, every leaf within 1e-12."""
    base = jnav.nav_spec(N=24, Ts=0.45, vertex_lists=VERTS)
    jspecs = [dataclasses.replace(base, x0=base.x0.at[1].add(dy))
              for dy in (-0.4, -0.2, 0.2)]
    jbatch = jax.tree.map(lambda *a: jnp.stack(a), *jspecs)
    specs = tspec.stack([_port_spec(s) for s in jspecs])
    jcfg = JSolverConfig(max_iter=150)
    cfg = config_from_numpy(_to_numpy_tree(jcfg))
    full = ipm.solve_batch(specs, cfg, prob=nav)
    assert bool((full.status == ipm.STATUS_CONVERGED).all())
    cap = int(full.iters.min())
    assert cap < int(full.iters.max())
    jcapped = JSolverConfig(max_iter=cap)
    capped = config_from_numpy(_to_numpy_tree(jcapped))
    res1 = ipm.solve_batch(specs, capped, prob=nav)
    failed = res1.status != ipm.STATUS_CONVERGED
    assert 0 < int(failed.sum()) < 3
    res = ipm.solve_batch_rescued(specs, capped, prob=nav, rescue_rounds=1)
    assert bool((res.status == ipm.STATUS_CONVERGED).all())
    assert bool((res.iters[failed] > cap).all())
    assert bool((res.iters[~failed] == res1.iters[~failed]).all())
    jres = jax.jit(lambda sp: jipm.solve_batch_rescued(
        sp, jcapped, prob=jnav, rescue_rounds=1))(jbatch)
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    _close(res.U, jres.U, atol=1e-6)

    W0 = nav.default_init(specs)
    d = ipm.cold_dual_state(specs, cfg, W0, prob=nav)
    jd = jax.jit(jax.vmap(lambda sp, w: jipm.cold_dual_state(
        sp, jcfg, w, prob=jnav)))(jbatch, jnp.asarray(W0.numpy()))
    L = nav.layout_of(specs)
    assert d.nu.shape == (3, L.N + 1, L.nc)
    assert d.zL.shape == W0.shape
    for f in dataclasses.fields(ipm.DualState):
        _close(getattr(d, f.name), getattr(jd, f.name), atol=1e-12)
    _, _, in_row, *_ = ipm._masks_and_bounds(L, specs, nav)
    assert bool((d.nu[in_row > 0] < 0).all())


def jax_reference_count(B=128, seed=0, max_iter=150):
    """The JAX package's converged count on the nav card test's batch
    (``test_torch_card_paths.test_nav_batch``): ``nav_spec()`` at its
    defaults (N=60) on the grazing layout, lane b's start y shifted by
    ``np.random.default_rng(seed).uniform(-0.4, 0.4, B)[b]``, solved by
    ``ipm.solve_batch_rescued(..., prob=nav)`` under the float64
    ``SolverConfig(max_iter=max_iter)`` on the CPU."""
    base = jnav.nav_spec(vertex_lists=VERTS)
    dy = np.random.default_rng(seed).uniform(-0.4, 0.4, B)
    x0 = np.tile(np.asarray(base.x0), (B, 1))
    x0[:, 1] += dy
    specs = jax.tree.map(
        lambda a: jnp.asarray(np.broadcast_to(np.asarray(a),
                                              (B,) + np.shape(a))), base)
    specs = dataclasses.replace(specs, x0=jnp.asarray(x0))
    cfg = JSolverConfig(max_iter=max_iter)
    res = jax.jit(lambda sp: jipm.solve_batch_rescued(sp, cfg, prob=jnav))(
        specs)
    status = np.asarray(res.status)
    return {"B": B, "N": base.N, "jax_converged":
            int((status == jipm.STATUS_CONVERGED).sum()),
            "status_counts": {int(k): int(v) for k, v in zip(
                *np.unique(status, return_counts=True))},
            "iters_median": float(np.median(np.asarray(res.iters))),
            "iters_max": int(np.asarray(res.iters).max())}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_nav.py prints the JAX
    # package's converged count on the nav card test's batch.
    import json

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(jax_reference_count()))
