"""obca_torch's receding-horizon MPC against obca_tpu.mpc.

The reverse-parking instance of ``tests/test_mpc.py`` (N=40, Ts=0.6) is
rebuilt for the port with ``obca_torch.convert.spec_from_numpy``; its
initial plan is the JAX package's converged solve from the port's
lattice warm start, passed to the port through ``convert`` (primal and
full dual state).  Both closed loops run under ``SolverConfig(max_iter=
80, mu_init=1e-3)`` in float64 on the CPU, the JAX one jitted once with
the initial plan and the disturbance as arguments.  Shifts must agree
exactly; statuses and iterations must be equal; states and controls
within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import mpc, nlp
from obca_torch import spec as tspec
from obca_torch.convert import (config_from_numpy, dual_state_from_numpy,
                                spec_from_numpy)
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric
from obca_tpu import mpc as jmpc
from obca_tpu import nlp as jnlp
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import SolverConfig as JSolverConfig
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

N, TS, STEPS = 40, 0.6, 3
TOL = 1e-6


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


def _port_duals(jd):
    return dual_state_from_numpy(
        {name: np.asarray(v) for name, v in jd._asdict().items()},
        device="cpu")


def _port_result(jres):
    """A JAX SolveResult (one instance) as the port's."""
    return ipm.SolveResult(
        *[torch.tensor(np.asarray(v)) for v in jres[:-1]],
        duals=_port_duals(jres.duals))


def _batch(d):
    return tspec.map_tensors(lambda t: t[None], d)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _same_steps(res, jres):
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    assert int(res.status0) == int(jres.status0)
    assert int(res.iters0) == int(jres.iters0)
    _close(res.states, jres.states)
    _close(res.controls, jres.controls)


@pytest.fixture(scope="module")
def case():
    """(JAX spec, port spec, lattice warm start W0, JAX converged initial
    plan, port config, JAX closed loop jitted over (spec, W0, res0,
    disturbance))."""
    jspec = j_reverse_parking_spec(N=N, Ts=TS)
    spec = spec_from_numpy(_to_numpy_tree(jspec), device="cpu")
    W0 = geometric.lattice_warm_start(spec)
    jres0 = jax.jit(lambda sp, w: jipm.solve_single(
        sp, JSolverConfig(max_iter=200), w))(jspec, jnp.asarray(W0.numpy()))
    assert int(jres0.status) == jipm.STATUS_CONVERGED
    jcfg = JSolverConfig(max_iter=80, mu_init=jnp.asarray(1e-3))
    jrun = jax.jit(lambda sp, w, r0, dd: jmpc.run(
        sp, jcfg, STEPS, W0=w, res0=r0, disturbance=dd))
    cfg = config_from_numpy(_to_numpy_tree(jcfg))
    return jspec, spec, W0, jres0, cfg, jrun


def test_shift_plan_and_dual_state_match_jax(case):
    """Both shifts of the converged plan agree exactly (batch-major: the
    stage axis is axis 1), and the boundary-condition multipliers of
    stage 0 stay."""
    jspec, spec, _, jres0, _, _ = case
    Lj = jnlp.layout_of(jspec)
    L = nlp.layout_of(spec)
    W = torch.tensor(np.asarray(jres0.W))[None]
    np.testing.assert_array_equal(
        mpc.shift_plan(W, L)[0].numpy(),
        np.asarray(jax.jit(lambda w: jmpc.shift_plan(w, Lj))(jres0.W)))
    d = _batch(_port_duals(jres0.duals))
    got = mpc.shift_dual_state(d, L)
    want = jax.jit(lambda dd: jmpc.shift_dual_state(dd, Lj))(jres0.duals)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name)[0].numpy(),
                                      np.asarray(getattr(want, f.name)))
    np.testing.assert_array_equal(got.nu[0, 0, L.r_bc].numpy(),
                                  np.asarray(jres0.duals.nu)[0, L.r_bc])
    # The input is left as it was.
    np.testing.assert_array_equal(d.nu[0].numpy(),
                                  np.asarray(jres0.duals.nu))


def test_warm_resolve_strict_steps_matches_jax(case):
    """The re-solve configuration rounds its knobs through float32 as
    the JAX package does, and a warm re-solve under it (strict steps
    on) matches the JAX closed loop's: from the converged plan and its
    duals at x0 (the loop's step 0), and from the shifted plan at the
    state the plant reached (step 1): the same status and iterations,
    the first control within 1e-6."""
    jspec, spec, W0, jres0, cfg, jrun = case
    cfg_warm = mpc.resolve_config(cfg, resolve_mu=1e-4)
    assert cfg_warm.strict_steps and cfg_warm.max_iter == 60
    assert float(cfg_warm.mu_init) == float(np.float32(1e-4)) != 1e-4
    assert float(cfg_warm.delta_w) == float(np.float32(1e-4))
    assert cfg_warm.mu_init.dtype == torch.float64
    jr = jrun(jspec, jnp.asarray(W0.numpy()), jres0,
              jnp.zeros((STEPS, 4)))
    res0 = _port_result(jres0)
    r0 = ipm.solve_single(spec, cfg_warm, res0.W, duals0=res0.duals)
    assert int(r0.status) == int(jr.status[0]) == ipm.STATUS_CONVERGED
    assert int(r0.iters) == int(jr.iters[0])
    _close(r0.U[0], jr.controls[0])

    L = nlp.layout_of(spec)
    x1 = torch.tensor(np.asarray(jr.states[1]))
    W1 = mpc.shift_plan(r0.W[None], L)[0].clone()
    W1[0, L.sl_x] = x1
    d1 = mpc.shift_dual_state(_batch(r0.duals), L)
    spec1 = dataclasses.replace(spec, x0=x1, u_prev=r0.U[0])
    r1 = ipm.solve_single(spec1, cfg_warm, W1,
                          duals0=tspec.map_tensors(lambda t: t[0], d1))
    assert int(r1.status) == int(jr.status[1])
    assert int(r1.iters) == int(jr.iters[1])
    _close(r1.U[0], jr.controls[1])


@pytest.mark.parametrize("disturbed", [False, True])
def test_run_matches_jax(case, disturbed):
    """``run`` for 3 control periods from the JAX package's converged
    plan, without and with a seeded state disturbance (0.01 N(0, 1)):
    per-step status and iterations equal, states and controls within
    1e-6; every re-solve converges and the car moves toward its goal."""
    jspec, spec, W0, jres0, cfg, jrun = case
    dist = (0.01 * np.random.default_rng(0).standard_normal((STEPS, 4))
            if disturbed else np.zeros((STEPS, 4)))
    res = mpc.run(spec, cfg, STEPS, W0=W0, res0=_port_result(jres0),
                  disturbance=torch.tensor(dist) if disturbed else None)
    jr = jrun(jspec, jnp.asarray(W0.numpy()), jres0, jnp.asarray(dist))
    assert res.states.shape == (STEPS + 1, 4)
    assert res.controls.shape == (STEPS, 2)
    _same_steps(res, jr)
    assert bool((res.status == ipm.STATUS_CONVERGED).all())
    d0 = float(torch.linalg.norm(spec.x0[:2] - spec.xF[:2]))
    dT = float(torch.linalg.norm(res.states[-1, :2] - spec.xF[:2]))
    assert dT < d0


def test_run_initial_plan_failure_matches_jax(case):
    """An initial plan that did not converge: the loop starts from W0
    with the solver's cold duals (``ipm.cold_dual_state``), not the
    failed solve's duals, in the port as in the JAX package."""
    jspec, spec, W0, jres0, cfg, jrun = case
    # (status * 0 + 1 keeps the array's type, so jrun does not retrace.)
    jfail = jres0._replace(status=jres0.status * 0 + jipm.STATUS_RUNNING)
    res = mpc.run(spec, cfg, STEPS, W0=W0, res0=_port_result(jfail))
    jr = jrun(jspec, jnp.asarray(W0.numpy()), jfail, jnp.zeros((STEPS, 4)))
    assert int(res.status0) == ipm.STATUS_RUNNING
    _same_steps(res, jr)


def test_run_fleet_matches_single_runs(case):
    """``run_fleet`` with 2 lanes x 2 steps (the second start shifted by
    0.05 m, as ``test_mpc_fleet_rescued_initial``) from the converged
    plan: initial plans and every re-solve converged, the batch shapes,
    and the shifted lane within 1e-9 of ``run`` of that lane alone
    (which solves its own initial plan), with the same iterations."""
    _, spec, _, jres0, _, _ = case
    cfg = dataclasses.replace(
        config_from_numpy(_to_numpy_tree(JSolverConfig(max_iter=200))),
        mu_init=torch.tensor(1e-3, dtype=torch.float64))
    lanes = [spec, dataclasses.replace(
        spec, x0=spec.x0 + torch.tensor([0.05, 0.0, 0.0, 0.0],
                                        dtype=torch.float64))]
    W = torch.tensor(np.asarray(jres0.W))
    res = mpc.run_fleet(tspec.stack(lanes), cfg, 2, torch.stack([W, W]))
    assert res.states.shape == (2, 3, 4)
    assert res.controls.shape == (2, 2, 2)
    assert res.status.shape == res.iters.shape == (2, 2)
    assert bool((res.status0 == ipm.STATUS_CONVERGED).all())
    assert bool((res.status == ipm.STATUS_CONVERGED).all())
    one = mpc.run(lanes[1], cfg, 2, W0=W)
    np.testing.assert_array_equal(one.iters.numpy(), res.iters[1].numpy())
    assert int(one.iters0) == int(res.iters0[1])
    _close(one.states, res.states[1], atol=1e-9)
    _close(one.controls, res.controls[1], atol=1e-9)


def first_periods(B=8, steps=2, seed=0):
    """The first periods of the card tests' MPC fleet
    (``full_size_batches.mpc_fleet_batch``) cut to B lanes, in float32
    on the CPU, in the port and in the JAX package from the same warm
    starts: each side's initial-plan iterations and per-period statuses
    and iterations; and, for the port's lane 0, the KKT error after the
    first re-solve iteration beside w_reg times the largest change of
    the duals between the warm start and the initial plan (the re-solve
    anchors its proximal dual term at the plan)."""
    import sys

    sys.path.insert(0, "bench")
    import _common
    import full_size_batches as fsb
    from obca_torch import f32_solver_config
    from obca_torch.warmstart import lattice
    from obca_tpu.spec import f32_solver_config as j_f32_solver_config

    base, specs = fsb.mpc_fleet_batch(torch.device("cpu"), B=B, seed=seed)
    cfg = f32_solver_config(max_iter=fsb.ITERS_MPC)
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(specs, dtype=cfg.dtype, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    knobs = dict(resolve_mu=fsb.RESOLVE_MU,
                 resolve_max_iter=fsb.RESOLVE_ITERS,
                 resolve_tol=fsb.RESOLVE_TOL)
    res = mpc.run_fleet(specs, cfg, steps, W0, **knobs)
    jspecs = _common.scenario_batch(
        j_reverse_parking_spec(N=base.N, Ts=float(base.Ts),
                               dtype=jnp.float32), B, seed=seed,
        spread=fsb.MPC_SPREAD)
    assert np.array_equal(np.asarray(jspecs.x0), specs.x0.numpy())
    jres = jax.jit(lambda sp, w: jmpc.run_fleet(
        sp, j_f32_solver_config(max_iter=fsb.ITERS_MPC), steps, w, **knobs))(
        jspecs, jnp.asarray(W0.numpy()))

    plan = ipm.solve_batch(specs, cfg, W0)
    L = nlp.layout_of(specs)
    duals = np.s_[..., L.sl_lam.start:L.sl_mu.stop]
    shift = float((plan.W[duals] - W0[duals]).abs()[0].max())
    state, step, _, _ = ipm._make_step(
        specs, mpc.resolve_config(cfg, **knobs), plan.W, plan.duals)
    out = {"B": B, "N": base.N}
    for side, r in (("port", res), ("jax", jres)):
        out[side] = {"iters0": np.asarray(r.iters0).tolist(),
                     "status": np.asarray(r.status).T.tolist(),
                     "iters": np.asarray(r.iters).T.tolist()}
    out["lane0_first_resolve_err"] = float(step(state).err[0])
    out["lane0_w_reg_times_dual_shift"] = float(specs.w_reg[0]) * shift
    return out


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_mpc.py prints first_periods().
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(first_periods()))
