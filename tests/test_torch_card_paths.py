"""obca_torch's paths at full size on the card: the f32 and mixed main
paths, the golden parity, the randomized families, MPC, nav, sharding,
the debug iterate and the kernel bench.

Every test needs a CUDA device and skips without one.  Like
``tests/test_torch_cuda.py``, this file imports neither JAX nor
obca_tpu, so both run where only the port is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py \\
        tests/test_torch_card_paths.py

The batches come from ``tests/full_size_batches.py``.  Launch counts
(``runtime.launches``) show which of the port's kernels a path ran:
the f32 route runs ``factor_se``, ``fwd_se`` and ``bwd_matvec_se``, the
mixed route ``bwd_se`` in place of ``bwd_matvec_se``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import full_size_batches as fsb
from obca_torch.solver.kernels import blocktri_se as bk

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_TOL = 1e-4  # kernels against their plain versions, relative
PARITY_TOL = 1e-3  # max |U - U_gold|
LANE_TOL = 1e-3    # clearance below d_min and distance to xF allowed
ROUTES = {"f32": ("bwd_matvec_se", "bwd_se"),
          "mixed": ("bwd_se", "bwd_matvec_se")}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _assert_route(launches, route):
    """``factor_se``, ``fwd_se`` and the route's backward kernel
    launched, the other route's not."""
    used, unused = ROUTES[route]
    assert min(launches["factor_se"], launches["fwd_se"],
               launches[used]) > 0, launches
    assert launches[unused] == 0, launches


def _assert_kernels_match(system, rhs, route):
    """The route's kernels within KERNEL_TOL of their plain versions on a
    captured system (K, ev, reg, pattern) and right-hand side, each fed
    the outputs of the kernel before it."""
    K, ev, reg, pat = system
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, rhs, pat)
    pairs = list(zip((Sinv, Wc), bk.factor_se_plain(K, ev, reg, pat)))
    pairs.append((y, bk.fwd_se_plain(Sinv, ev, rhs, pat)))
    if route == "f32":
        pairs += zip(bk.bwd_matvec_se(Wc, y, K, ev, pat),
                     bk.bwd_matvec_se_plain(Wc, y, K, ev, pat))
    else:
        pairs.append((bk.bwd_se(Wc, y, pat), bk.bwd_se_plain(Wc, y, pat)))
    for got, want in pairs:
        assert _rel(got, want) <= KERNEL_TOL


class FirstIterationCapture:
    """Records the (K, ev, reg, pattern) of the second factorization (the
    first IPM iteration; the first one is the dual least-squares start)
    and the right-hand side of the forward substitution that follows it,
    while passing every call through to the real wrapper.  With
    ``keep_last`` it also records the run's last factorization and the
    right-hand side after it (``last_system``, ``last_rhs``); the copies
    are made on the card and add no launch of the port's kernels.  The
    first IPM iteration is a solve's eager turn on either path; a
    replayed turn calls the forward substitution inside its CUDA graph,
    not from Python, so with ``keep_last`` the solve runs every turn
    eagerly (the same arithmetic, bit for bit)."""

    def __init__(self, keep_last=False):
        self.keep_last = keep_last
        self.n_factor = 0
        self.system = self.rhs = None
        self.last_system = self.last_rhs = None
        self._factor, self._fwd = bk.factor_se, bk.fwd_se

    def __enter__(self):
        def factor(K, ev, reg, pat):
            self.n_factor += 1
            copy = None
            if self.n_factor == 2 or self.keep_last:
                copy = (K.clone(), ev.clone(), reg.clone(), pat)
            if self.n_factor == 2:
                self.system = copy
            if self.keep_last:
                self.last_system, self.last_rhs = copy, None
            return self._factor(K, ev, reg, pat)

        def fwd(Sinv, ev, r, pat):
            if self.system is not None and self.rhs is None:
                self.rhs = r.clone()
            if self.last_system is not None and self.last_rhs is None:
                self.last_rhs = r.clone()
            return self._fwd(Sinv, ev, r, pat)

        bk.factor_se, bk.fwd_se = factor, fwd
        if self.keep_last:
            from obca_torch.solver import ipm

            self._use_graphs = ipm._use_graphs
            ipm._use_graphs = lambda device: False
        return self

    def __exit__(self, *exc):
        bk.factor_se, bk.fwd_se = self._factor, self._fwd
        if self.keep_last:
            from obca_torch.solver import ipm

            ipm._use_graphs = self._use_graphs


class _MainPaths(dict):
    """route -> (specs, result, launches, first-iteration capture) of
    the main path on that route, run once on first use: the batch in
    float32 ("f32") or float64 ("mixed"), one shared ``plan_field``,
    per-lane ``lattice_warm_start`` and ``solve_batch_rescued`` (cap 55,
    rescue mu 1e-5), counted."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    def __missing__(self, route):
        from obca_torch.solver import ipm

        dtype = torch.float32 if route == "f32" else torch.float64
        base, specs = fsb.main_path_batch(self.device, dtype=dtype)
        bk.reset_launches()
        with FirstIterationCapture() as cap:
            cfg, W0 = fsb.main_path_start(base, specs)
            res = ipm.solve_batch_rescued(specs, cfg, W0, rescue_mu=1e-5)
            torch.cuda.synchronize()
        self[route] = (specs, res, dict(bk.launches), cap)
        return self[route]


@pytest.fixture(scope="module")
def main_paths(cuda):
    return _MainPaths(cuda)


@pytest.mark.parametrize("route", ["f32", "mixed"])
def test_main_path(route, main_paths):
    """The main path at B=128, N=80 on each route: U finite and [B, N,
    2], the route's kernels launched and the other route's not; on the
    mixed route, ``solve_se`` within 1e-4 relative of its plain version
    on the first IPM iteration's system."""
    _, res, launches, cap = main_paths[route]
    assert bool(torch.isfinite(res.U).all())
    assert res.U.shape == (fsb.B_MAIN, fsb.N_MAIN, 2)
    _assert_route(launches, route)
    if route == "mixed":
        K, ev, reg, pat = cap.system
        Sinv, Wc = bk.factor_se(K, ev, reg, pat)
        x = bk.solve_se(Sinv, Wc, ev, cap.rhs, pat)
        assert _rel(x, bk.solve_se_plain(Sinv, Wc, ev, cap.rhs, pat)) \
            <= KERNEL_TOL


def test_first_iteration_system(main_paths):
    """On the f32 main path's first-iteration system (Ruiz-scaled, as the
    solver factors it): the four structured kernels' outputs finite, and
    the dense-coupling solver ``kkt.make_kkt_solver`` (E built from the
    coupling values) within 1e-3 relative of ``make_kkt_solver_se``, d
    finite, with ``factor_dense``, ``fwd_dense`` and ``bwd_dense``
    launched."""
    from obca_torch import nlp
    from obca_torch.solver import kkt

    specs, _, _, cap = main_paths["f32"]
    K, ev, reg, pat = cap.system
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, cap.rhs, pat)
    outs = [Sinv, Wc, y, *bk.bwd_matvec_se(Wc, y, K, ev, pat),
            bk.bwd_se(Wc, y, pat)]
    assert all(bool(torch.isfinite(t).all()) for t in outs)

    L = nlp.layout_of(specs)
    rows, cols = nlp.coupling_structure(L)
    B, S, nz, _ = K.shape
    E = torch.zeros((B, S - 1, nz, nz), dtype=K.dtype, device=K.device)
    E[:, :, torch.as_tensor(rows, device=K.device),
      torch.as_tensor(cols, device=K.device)] = ev
    f32 = torch.float32
    bk.reset_launches()
    d_dense, _ = kkt.make_kkt_solver(L.nw, 4, f32, f32)(K, E, reg, cap.rhs)
    d_se, _ = kkt.make_kkt_solver_se(L.nw, 4, f32, f32, rows, cols)(
        K, ev, reg, cap.rhs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d_dense).all())
    assert _rel(d_dense, d_se) <= 1e-3
    for name in ("factor_dense", "fwd_dense", "bwd_dense"):
        assert bk.launches[name] > 0


# case -> (golden, family, signed, configuration, its arguments)
GOLDENS = {
    "reverse_f32": ("reverse_parking_N80", "reverse", True,
                    "f32_solver_config", {}),
    "reverse_mixed": ("reverse_parking_N80", "reverse", True,
                      "mixed_solver_config", {}),
    "reverse_dist_mixed": ("reverse_parking_dist_N80", "reverse", False,
                           "mixed_solver_config", {"max_iter": 200}),
    "parallel_fastpath": ("parallel_parking_N80", "parallel", True,
                          "parallel_fastpath_config", {}),
    "free_time_f32": ("reverse_parking_freetime_N80", "reverse", True,
                      "f32_solver_config", {"max_iter": fsb.ITERS_PARALLEL}),
}


@pytest.mark.parametrize("case", list(GOLDENS))
def test_golden_parity(case, cuda):
    """max |U - U_gold| < 1e-3 for one golden instance solved at B=1 from
    its warm start, in the configuration's iterate dtype: reverse parking
    under ``f32_solver_config()`` and ``mixed_solver_config()``, the
    unsigned-distance one under ``mixed_solver_config(max_iter=200)``,
    parallel parking under ``parallel_fastpath_config()``, and the
    free-time one through ``ipm.solve_free_time`` under
    ``f32_solver_config(max_iter=250)``."""
    import obca_torch as ot
    from obca_torch.solver import ipm

    golden, family, signed, config, kwargs = GOLDENS[case]
    cfg = getattr(ot, config)(**kwargs)
    gold = np.load(os.path.join(ROOT, "oracle", "goldens", f"{golden}.npz"))
    fix_time = bool(gold["fix_time"])
    make = {"reverse": ot.reverse_parking_spec,
            "parallel": ot.parallel_parking_spec}[family]
    spec = make(N=int(gold["N"]), Ts=float(gold["Ts"]), signed=signed,
                fix_time=fix_time, dtype=cfg.dtype, device=cuda)
    W0 = torch.as_tensor(gold["W0"], dtype=cfg.dtype, device=cuda)
    solve = ipm.solve_single if fix_time else ipm.solve_free_time
    res = solve(spec, cfg, W0)
    assert float(np.abs(res.U.double().cpu().numpy() - gold["U"]).max()) \
        < PARITY_TOL


def _clearance_margin(sp, x, gap):
    """The smallest clearance of poses x [K, 4] of one lane minus its
    d_min, from their SAT gaps [K] (which never exceed the distance),
    each gap below d_min - LANE_TOL replaced by the exact polygon
    distance of that pose to its nearest real obstacle."""
    from obca_torch import geometry
    from obca_torch import spec as tspec

    d_min = float(sp.d_min)
    gap = gap.cpu().numpy()
    ob = tspec.map_tensors(lambda t: t.cpu().numpy(), sp.obstacles)
    ego = sp.ego_g.cpu().numpy()
    xs = x.cpu().numpy()
    for k in np.flatnonzero(gap < d_min - LANE_TOL):
        gap[k] = min(
            geometry.ego_obstacle_distance(xs[k, :3], ego, ob.A[m],
                                           ob.b[m], ob.face_mask[m])
            for m in range(ob.num_obs) if ob.obs_mask[m] > 0)
    return float(gap.min()) - d_min


@pytest.mark.parametrize("family,B,n_layouts,min_converged", [
    ("reverse", fsb.B_MAIN, 8, 116), ("parallel", fsb.B_PARALLEL, 4, 16)])
def test_random_family(family, B, n_layouts, min_converged, cuda):
    """``bench/run_sweep.py``'s shard on the f32 route: the
    topology-varied reverse family (B=128, 8 layouts, nz = 72, cap 70)
    or the parallel family (B=32, 4 layouts, cap 250, mu 1e-3, delta_w
    1e-4), one plan field per layout, the grouped lattice warm start and
    ``solve_batch_rescued`` (rescue mu 1e-5), counted: at least
    ``min_converged`` lanes converged, and every converged lane clear of
    its own obstacles by d_min - 1e-3 at every stage (the SAT gap, and
    the exact polygon distance where the gap is below) and within 1e-3
    of its own goal."""
    from obca_torch import f32_solver_config, geometry, nlp
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric

    specs, layouts, lcfg = fsb.random_family_batch(cuda, family, B,
                                                   n_layouts)
    if family == "reverse":
        assert nlp.layout_of(specs).nz == 72
        cfg = f32_solver_config(max_iter=fsb.ITERS_RANDOM)
    else:
        cfg = f32_solver_config(max_iter=fsb.ITERS_PARALLEL, mu_init=1e-3,
                                delta_w=1e-4)
    bk.reset_launches()
    W0 = geometric.grouped_lattice_warm_start(
        specs, layouts, lcfg, dtype=cfg.dtype,
        fields=geometric.layout_fields(layouts, lcfg))
    res = ipm.solve_batch_rescued(specs, cfg, W0, rescue_mu=1e-5)
    torch.cuda.synchronize()
    _assert_route(dict(bk.launches), "f32")
    ok = (res.status == ipm.STATUS_CONVERGED).cpu().numpy()
    assert int(ok.sum()) >= min_converged
    X = res.X.double()
    for i in np.flatnonzero(ok):
        sp = tspec.cast_floats(tspec.take(specs, int(i)), X.dtype)
        x = X[i].to(sp.x0.device)
        gap = geometry.ego_clearance_flat(x[:, 0], x[:, 1], x[:, 2],
                                          sp.ego_g, sp.obstacles)
        assert not _clearance_margin(sp, x, gap) < -LANE_TOL, i
        assert not float((x[-1] - sp.xF).abs().max()) > LANE_TOL, i


MPC_STEPS, MPC_RUN_STEPS = 30, 4
MPC_MIN_STEP_CONV = 0.90


def _run_mpc_fleet(base, specs, cfg, steps):
    """One plan field for the fleet, a per-lane lattice warm start, then
    ``mpc.run_fleet`` for ``steps`` periods with ``bench/run_mpc.py``'s
    re-solve knobs."""
    from obca_torch import mpc
    from obca_torch.warmstart import geometric, lattice

    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(specs, dtype=cfg.dtype, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    res = mpc.run_fleet(specs, cfg, steps, W0, resolve_mu=fsb.RESOLVE_MU,
                        resolve_max_iter=fsb.RESOLVE_ITERS,
                        resolve_tol=fsb.RESOLVE_TOL)
    torch.cuda.synchronize()
    return res


def test_mpc_fleet(cuda):
    """``bench/run_mpc.py``'s fleet (128 vehicles, f32, cap 70) for 30
    periods, counted on the f32 route: every initial plan converged, at
    least 90% of the period re-solves converged, every closed-loop state
    finite and clear of its obstacles by d_min - 1e-3
    (``geometry.ego_clearance_exact``, the exact polygon distance where
    that gap is below), and every rollout nearer its goal at the end
    than at the start."""
    from obca_torch import f32_solver_config, geometry
    from obca_torch import spec as tspec

    base, specs = fsb.mpc_fleet_batch(cuda)
    bk.reset_launches()
    res = _run_mpc_fleet(base, specs, f32_solver_config(
        max_iter=fsb.ITERS_MPC), MPC_STEPS)
    _assert_route(dict(bk.launches), "f32")
    assert float((res.status0 == 0).float().mean()) == 1.0
    assert float((res.status == 0).float().mean()) >= MPC_MIN_STEP_CONV
    states = res.states.double()
    assert bool(torch.isfinite(states).all())
    for i in range(states.shape[0]):
        sp = tspec.cast_floats(tspec.take(specs, i), torch.float64)
        x = states[i].to(sp.x0.device)
        gap = geometry.ego_clearance_exact(x, sp.ego_g, sp.obstacles)
        assert not _clearance_margin(sp, x, gap.amin(-1)) < -LANE_TOL, i
    goal = specs.xF[:, :2].double()
    d_start = (states[:, 0, :2] - goal).norm(dim=-1)
    d_end = (states[:, -1, :2] - goal).norm(dim=-1)
    assert int((d_end >= d_start).sum()) == 0


def test_mpc_single_vehicle(cuda):
    """Rollout 0 of the fleet alone (B = 1): the f32 route's kernels
    within 1e-4 relative of their plain versions on its period-2
    re-solve system (an eager run); its ``mpc.run_fleet`` for 30 periods
    with the turns replayed as CUDA graphs, counted on the f32 route;
    then its ``mpc.run`` from its ``ipm.solve_single`` plan for 4
    periods, counted on the f32 route, against ``mpc.run_fleet`` at B = 1
    from the same warm start: the same plan and period statuses, every
    closed-loop state finite and within 1e-3 of the fleet's."""
    from obca_torch import f32_solver_config, mpc
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric, lattice

    base, specs = fsb.mpc_fleet_batch(cuda)
    cfg = f32_solver_config(max_iter=fsb.ITERS_MPC)
    one = tspec.take(specs, slice(0, 1))
    with FirstIterationCapture(keep_last=True) as cap:
        _run_mpc_fleet(base, one, cfg, 2)
    _assert_kernels_match(cap.last_system, cap.last_rhs, "f32")
    bk.reset_launches()
    _run_mpc_fleet(base, one, cfg, MPC_STEPS)
    _assert_route(dict(bk.launches), "f32")

    spec0 = tspec.take(specs, 0)
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(one, dtype=cfg.dtype, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    knobs = dict(resolve_mu=fsb.RESOLVE_MU,
                 resolve_max_iter=fsb.RESOLVE_ITERS,
                 resolve_tol=fsb.RESOLVE_TOL)
    bk.reset_launches()
    res0 = ipm.solve_single(spec0, cfg, W0[0])
    res = mpc.run(spec0, cfg, MPC_RUN_STEPS, W0[0], res0=res0, **knobs)
    torch.cuda.synchronize()
    _assert_route(dict(bk.launches), "f32")
    fleet = mpc.run_fleet(one, cfg, MPC_RUN_STEPS, W0, **knobs)
    assert int(res.status0) == int(fleet.status0[0])
    assert res.status.tolist() == fleet.status[0].tolist()
    assert bool(torch.isfinite(res.states).all())
    assert float((res.states - fleet.states[0]).abs().max()) < 1e-3


# The JAX package's converged count on the nav batch (float64 on a CPU:
# PYTHONPATH=. python tests/test_torch_nav.py prints it, from
# jax_reference_count); the port may converge NAV_COUNT_SLACK fewer.
NAV_JAX_CONVERGED, NAV_COUNT_SLACK = 128, 3
NAV_BC_TOL, NAV_CLEAR_TOL = 1e-5, 1e-4


def _same_result(a, b):
    """Whether two ``SolveResult``s are equal bit for bit, the dual
    state included."""
    pairs = list(zip(a[:-1], b[:-1])) + [
        (getattr(a.duals, f.name), getattr(b.duals, f.name))
        for f in dataclasses.fields(a.duals)]
    return all(torch.equal(x, y) for x, y in pairs)


def test_nav_batch(cuda):
    """The nav batch (B=128, N=60, nz = 44) through
    ``solve_batch_rescued(..., prob=nav)`` under
    ``mixed_solver_config(max_iter=150)``, counted on the mixed route
    with its turns replayed as CUDA graphs: every converged lane within
    1e-5 of its boundary conditions and every stage point at least d_min
    - 1e-4 outside every obstacle; at least the JAX package's converged
    count less 3; lane 0 converged and within 1e-3 of the port's float64
    solve of its spec on the CPU; an eager solve of the batch equal to it
    bit for bit; the mixed route's kernels within 1e-4 relative of their
    plain versions on the first IPM iteration's system and on the eager
    solve's last one (a rescue round's, at fewer lanes, when one ran)."""
    from obca_torch import SolverConfig, mixed_solver_config, nav
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm

    _, specs = fsb.nav_batch(cuda)
    cfg = mixed_solver_config(max_iter=fsb.ITERS_NAV)
    bk.reset_launches()
    with FirstIterationCapture() as cap:
        res = ipm.solve_batch_rescued(specs, cfg, prob=nav)
        torch.cuda.synchronize()
    _assert_route(dict(bk.launches), "mixed")
    with FirstIterationCapture(keep_last=True) as last:
        eager = ipm.solve_batch_rescued(specs, cfg, prob=nav)
    assert _same_result(res, eager)
    _assert_kernels_match(cap.system, cap.rhs, "mixed")
    _assert_kernels_match(last.last_system, last.last_rhs, "mixed")

    ok = res.status == ipm.STATUS_CONVERGED
    X = res.X.double()
    bc = torch.maximum((X[:, 0] - specs.x0).abs().amax(-1),
                       (X[:, -1] - specs.xF).abs().amax(-1))
    ob = specs.obstacles
    face = (torch.einsum("bmvd,bkd->bkmv", ob.A, X[..., :2])
            - ob.b[:, None])
    face = torch.where(ob.face_mask[:, None] > 0, face,
                       torch.full_like(face, -float("inf")))
    clear = torch.where(ob.obs_mask[:, None] > 0, face.amax(-1),
                        torch.full_like(face[..., 0], float("inf")))
    margin = clear.amin(dim=(1, 2)) - specs.d_min
    assert int((bc[ok] > NAV_BC_TOL).sum()) == 0
    assert int((margin[ok] < -NAV_CLEAR_TOL).sum()) == 0
    assert int(ok.sum()) >= NAV_JAX_CONVERGED - NAV_COUNT_SLACK

    spec0 = tspec.map_tensors(lambda t: t.cpu(), tspec.take(specs, 0))
    ref = nav.solve(spec0, SolverConfig(max_iter=fsb.ITERS_NAV))
    assert int(res.status[0]) == ipm.STATUS_CONVERGED
    assert float((res.U[0].double().cpu() - ref.U).abs().max()) <= PARITY_TOL


def _equal(a, b):
    """``torch.equal``, with NaN equal to NaN at the same places."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0), b.masked_fill(nan_b, 0))


@pytest.mark.parametrize("family", ["parking", "nav"])
def test_ruiz_kernel_whole_solve(family, cuda, monkeypatch):
    """The f32 main path (B=128) and the nav batch (B=128, float64 IPM),
    each solved with ``ruiz_se``'s kernel and again with the wrapper
    swapped for its plain version: W, nu, iters and status equal bit for
    bit, and the kernel launched once an IPM turn (the trace's
    ``ipm.iters``), replayed turns included."""
    from obca_torch import mixed_solver_config, nav, trace
    from obca_torch.solver import ipm

    if family == "parking":
        base, specs = fsb.main_path_batch(cuda)
        cfg, W0 = fsb.main_path_start(base, specs)

        def solve():
            return ipm.solve_batch_rescued(specs, cfg, W0, rescue_mu=1e-5)
    else:
        _, specs = fsb.nav_batch(cuda)
        cfg = mixed_solver_config(max_iter=fsb.ITERS_NAV)

        def solve():
            return ipm.solve_batch_rescued(specs, cfg, prob=nav)

    bk.reset_launches()
    trace.take()
    trace.enable()
    try:
        res = solve()
        torch.cuda.synchronize()
    finally:
        trace.enable(False)
    _, counters = trace.take()
    assert bk.launches["ruiz_se"] == counters["ipm.iters"] > 0
    assert counters["ipm.graph_replays"] > 0
    monkeypatch.setattr(bk, "ruiz_se", bk.ruiz_se_plain)
    bk.reset_launches()
    plain = solve()
    assert bk.launches["ruiz_se"] == 0
    for field in ("W", "nu", "iters", "status"):
        assert _equal(getattr(res, field), getattr(plain, field)), field


def _free_port():
    """A free localhost TCP port for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(cuda):
    """The f32 main path's batch from its lattice warm starts (cap 55):
    ``solve_sharded`` over a one-rank NCCL group and its global mesh,
    counted, and ``ipm.solve_batch`` on the same inputs; the group is
    destroyed before the fixture returns.  Returns (specs, W0, sharded
    result, reduced metrics, launches, solve_batch's result)."""
    from obca_torch import f32_solver_config
    from obca_torch.parallel import distributed
    from obca_torch.parallel import mesh as mesh_mod
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric, lattice

    base, specs = fsb.main_path_batch(cuda)
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(specs, dtype=base.x0.dtype, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    cfg = f32_solver_config(max_iter=fsb.ITERS_MAIN)
    distributed.initialize(f"localhost:{_free_port()}", num_processes=1,
                           process_id=0, local_device_ids=[str(cuda)],
                           backend="nccl")
    try:
        mesh = distributed.global_scenario_mesh()
        bk.reset_launches()
        res, met = mesh_mod.solve_sharded(specs, cfg, mesh, W0)
        torch.cuda.synchronize()
        launches = dict(bk.launches)
        ref = ipm.solve_batch(specs, cfg, W0)
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
    return specs, W0, res, met, launches, ref


def test_sharded_world_of_one(sharded):
    """``solve_sharded`` on one NCCL rank against ``solve_batch`` at
    B=128: statuses and iterations equal, max |dU| <= 1e-5, the
    all-reduced metrics equal to the same reductions made here (float64
    sums, the means divided after the sum), the f32 route launched."""
    from obca_torch.solver import ipm

    _, _, res, met, launches, ref = sharded
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    assert float((res.U - ref.U).abs().max()) <= 1e-5
    B = float(res.status.shape[0])
    f64 = torch.float64
    local = {
        "n_converged": int((res.status == ipm.STATUS_CONVERGED).sum()),
        "max_err": float(res.err.to(f64).max().to(res.err.dtype)),
        "mean_iters": float((res.iters.to(f64).sum() / B).float()),
        "mean_obj": float((res.obj.to(f64).sum() / B).to(res.obj.dtype)),
    }
    assert {k: float(v) for k, v in met.items()} == \
        {k: float(v) for k, v in local.items()}
    _assert_route(launches, "f32")


# One rank of the gloo test: joins the group, solves its process_shard
# of the batch in an npz file (spec leaves under "/"-joined keys, W0 and
# max_iter) under f32_solver_config, and writes its lanes, their
# statuses, iterations and errors, the all-reduced metrics and its
# launch counts.
SHARD_WORKER = r"""
import json
import sys
rank, world, port, root, inp, out, device = sys.argv[1:8]
sys.path.insert(0, root)
import numpy as np
import torch
from obca_torch import f32_solver_config
from obca_torch import spec as spec_mod
from obca_torch.convert import spec_from_numpy
from obca_torch.parallel import distributed
from obca_torch.parallel import mesh as mesh_mod
from obca_torch.solver.kernels import runtime

distributed.initialize(f"localhost:{port}", num_processes=int(world),
                       process_id=int(rank), local_device_ids=[device],
                       backend="gloo")
mesh = distributed.global_scenario_mesh()
flat = np.load(inp)
tree = {}
for key in flat.files:
    *path, leaf = key.split("/")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = flat[key]
W0 = torch.as_tensor(tree.pop("W0"), device=device)
cfg = f32_solver_config(max_iter=int(tree.pop("max_iter")))
specs = spec_from_numpy(tree, device=device, dtype=torch.float32)
lanes = distributed.process_shard(specs.x0.shape[0])
runtime.reset_launches()
res, met = mesh_mod.solve_sharded(spec_mod.take(specs, lanes), cfg, mesh,
                                  W0[lanes])
if torch.device(device).type == "cuda":
    torch.cuda.synchronize()
launches = dict(runtime.launches)
np.savez(out, lo=lanes.start, U=res.U.cpu().numpy(),
         status=res.status.cpu().numpy(), iters=res.iters.cpu().numpy(),
         err=res.err.cpu().numpy(), launches=json.dumps(launches),
         **{k: v.cpu().numpy() for k, v in met.items()})
torch.distributed.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "obca_tpu")]
if bad:
    sys.exit(f"worker imported {bad}")
"""
SHARD_RANKS, SHARD_WORKER_TIMEOUT, SHARD_COUNT_SLACK = 2, 300, 2


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _run_shard_workers(specs, W0, max_iter):
    """SHARD_RANKS worker processes over gloo on the batch's device, each
    solving its ``process_shard`` of the batch (written to a temporary
    npz file).  A worker that exits non-zero or outlives its timeout
    fails the test; every worker is stopped before this returns.
    Returns each rank's outputs, in the order of their lanes."""
    from obca_torch.convert import to_numpy_tree

    device = str(specs.x0.device)
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "batch.npz")
        np.savez(inp, W0=W0.cpu().numpy(), max_iter=max_iter,
                 **_flat_tree(to_numpy_tree(specs)))
        port = str(_free_port())
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        outs = [os.path.join(tmp, f"rank{r}.npz")
                for r in range(SHARD_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", SHARD_WORKER, str(r), str(SHARD_RANKS),
             port, ROOT, inp, outs[r], device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(SHARD_RANKS)]
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=SHARD_WORKER_TIMEOUT)
                assert p.returncode == 0, (
                    f"shard worker {r} exited {p.returncode}:\n{out}\n"
                    f"{err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for path in outs:
            with np.load(path) as f:
                d = {k: f[k] for k in f.files}
            d["launches"] = json.loads(str(d["launches"]))
            ranks.append(d)
    return sorted(ranks, key=lambda d: int(d["lo"]))


def test_shard_workers_over_gloo(sharded):
    """Two worker processes over gloo on the one card (NCCL refuses two
    ranks on one GPU), each on its ``process_shard`` (64 lanes) of the
    one-rank test's inputs: every rank's reduced converged count equal
    to the union's, its reduced max error the larger rank's, the union's
    converged count at least the one-rank solve's less 2, U within 1e-3
    of it on the lanes converged in both, the f32 route launched."""
    from obca_torch.solver import ipm

    specs, W0, res1, _, _, _ = sharded
    ranks = _run_shard_workers(specs, W0, fsb.ITERS_MAIN)
    status = np.concatenate([d["status"] for d in ranks])
    U = np.concatenate([d["U"] for d in ranks])
    ok = status == ipm.STATUS_CONVERGED
    ok1 = res1.status.cpu().numpy() == ipm.STATUS_CONVERGED
    both = ok & ok1
    assert {int(d["n_converged"]) for d in ranks} == {int(ok.sum())}
    assert {float(d["max_err"]) for d in ranks} == \
        {max(float(d["err"].max()) for d in ranks)}
    assert int(ok.sum()) >= int(ok1.sum()) - SHARD_COUNT_SLACK
    assert both.any()
    assert float(np.abs(U[both] - res1.U.cpu().numpy()[both]).max()) \
        <= PARITY_TOL
    launches = {}
    for d in ranks:
        for k, v in d["launches"].items():
            launches[k] = launches.get(k, 0) + v
    _assert_route(launches, "f32")


def test_debug_iterate(cuda):
    """``ipm.debug_iterate`` on the golden ``reverse_parking_N80`` warm
    start (B=1, ``f32_solver_config()``, 10 iterations): two lines an
    iteration, W within 1e-6 relative of 10 plain steps of the same
    ``_make_step``, and every diagnostic of the debug step finite."""
    import obca_torch as ot
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm

    n_iter = 10
    gold = np.load(os.path.join(ROOT, "oracle", "goldens",
                                "reverse_parking_N80.npz"))
    cfg = ot.f32_solver_config()
    spec = ot.reverse_parking_spec(N=int(gold["N"]), Ts=float(gold["Ts"]),
                                   dtype=cfg.dtype, device=cuda)
    W0 = torch.as_tensor(gold["W0"], dtype=cfg.dtype, device=cuda)
    lines = []
    state = ipm.debug_iterate(spec, cfg, W0, n_iter=n_iter,
                              printer=lines.append)

    def steps(debug):
        with torch.no_grad():
            st, step, _, _ = ipm._make_step(tspec.stack([spec]), cfg,
                                            W0[None], debug=debug)
            diags = []
            for _ in range(n_iter):
                out = step(st)
                st, d = out if debug else (out, None)
                diags.append(d)
        return st, diags

    plain, _ = steps(False)
    _, diags = steps(True)
    # Every diagnostic, the per-group dicts' values included.
    values = [x for d in diags for v in d.values()
              for x in (v.values() if isinstance(v, dict) else [v])]
    W = state.W.double()
    assert float((W - plain.W[0].double()).abs().max() / W.abs().max()) \
        <= 1e-6
    assert all(bool(torch.isfinite(v.float()).all()) for v in values)
    assert len(lines) == 2 * n_iter


def test_kernel_bench_launches_probes(cuda):
    """The kernel bench at B=128, N=80 (50-call chains) launches both of
    its probe kernels, ``stream_add_one`` and ``fma_probe``."""
    from obca_torch.tools import kernel_bench as kb

    bk.reset_launches()
    kb.measure(fsb.B_MAIN, fsb.N_MAIN, 50, cuda)
    assert bk.launches["stream_add_one"] > 0
    assert bk.launches["fma_probe"] > 0
