"""The host recorder ``obca_torch.trace`` around the port's solver, MPC
loop and warm starts, on the CPU at N=20-40.

* a solve gives the same results bit for bit with the recorder on and
  off, and records nothing when off;
* the span tree: each span opens only under the spans its phase belongs
  to, ``ipm.iter`` under ``ipm.solve``; one ``ipm.iter`` per loop turn
  (counted by wrapping the step), ``ipm.iters`` the same count and
  ``ipm.lane_slots`` B per turn;
* rescue rounds: one ``ipm.rescue`` per round run, ``ipm.rescue_lanes``
  the lanes the rounds re-solved;
* ``mpc.run_fleet`` at B=1: one ``mpc.plan``, one ``mpc.period`` a
  period, each holding an ``ipm.solve``;
* span times fall between two ``time.time_ns()`` readings around the
  call, children inside their parents;
* the recorder adds no host read of a device value.
"""

import dataclasses
import time
from collections import Counter

import pytest
import torch

from obca_torch import (SolverConfig, f32_solver_config, mpc, nav, nlp,
                        reverse_parking_spec, trace)
from obca_torch import spec as tspec
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric, lattice

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

# The spans each span may open directly under (None: at the top).
PARENTS = {
    "ipm.solve": {None, "ipm.rescue", "mpc.plan", "mpc.period"},
    "ipm.setup": {"ipm.solve"},
    "ipm.iter": {"ipm.solve"},
    "ipm.final": {"ipm.solve"},
    "ipm.sync": {None, "ipm.solve", "ipm.iter", "ipm.rescue", "mpc.plan"},
    "ipm.rescue": {None, "mpc.plan"},
    "ipm.residuals": {"ipm.iter"},
    "ipm.assemble": {"ipm.iter"},
    "ipm.ruiz": {"ipm.iter"},
    "ipm.recover_ftb": {"ipm.iter"},
    "ipm.merit_ls": {"ipm.iter"},
    "ipm.soc": {"ipm.iter"},
    "ipm.watchdog": {"ipm.iter"},
    "ipm.update": {"ipm.iter"},
    "nlp.constraint_blocks": {"ipm.assemble", "ipm.setup"},
    "kkt.solve": {"ipm.iter", "ipm.soc", "ipm.setup"},
    "kkt.factor": {"kkt.solve"},
    "kkt.refine": {"kkt.solve"},
    "mpc.plan": {None},
    "mpc.period": {None},
    "warmstart.plan_field": {None},
    "warmstart.lattice": {None},
}


@pytest.fixture(autouse=True)
def recorder_off():
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


def _shifted(base, shifts, axis=0):
    return tspec.stack([
        dataclasses.replace(base, x0=base.x0 + torch.tensor(
            [s if i == axis else 0.0 for i in range(4)],
            dtype=base.x0.dtype)) for s in shifts])


@pytest.fixture(scope="module")
def parking():
    """Three start shifts of reverse parking at N=20 with their lattice
    warm starts in float64."""
    base = reverse_parking_spec(N=20, Ts=1.2, device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(base)
    specs = _shifted(base, (-0.1, 0.0, 0.1))
    W0 = geometric.lattice_warm_start(specs, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    return base, lcfg, specs, W0


def _traced(fn, request=7):
    """(fn's result, spans, counters, ns before, ns after) of ``fn`` run
    with the recorder on."""
    trace.enable()
    trace.set_request(request)
    t0 = time.time_ns()
    try:
        out = fn()
    finally:
        t1 = time.time_ns()
        trace.enable(False)
        trace.set_request(None)
    spans, counters = trace.take()
    return out, spans, counters, t0, t1


def _check_tree(spans, t0, t1):
    """Every span where its phase belongs, inside its parent and inside
    [t0, t1]."""
    for sp in spans:
        parent = spans[sp.parent] if sp.parent >= 0 else None
        assert (parent.name if parent else None) in PARENTS[sp.name], sp
        assert t0 <= sp.start_ns <= sp.end_ns <= t1
        if parent:
            assert parent.start_ns <= sp.start_ns <= sp.end_ns \
                <= parent.end_ns


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _count_steps(monkeypatch):
    """Wrap the IPM's step: the batch size of each call, in order."""
    calls = []
    make = ipm._make_step

    def counting(*a, **kw):
        state0, step, L, final_check = make(*a, **kw)

        def counted(state):
            calls.append(state.W.shape[0])
            return step(state)

        return state0, counted, L, final_check

    monkeypatch.setattr(ipm, "_make_step", counting)
    return calls


def _fields(res):
    return list(res[:-1]) + [getattr(res.duals, f.name)
                             for f in dataclasses.fields(ipm.DualState)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_results_bitwise_on_and_off(parking, dtype):
    _, _, specs, W0 = parking
    cfg = f32_solver_config() if dtype == "float32" else SolverConfig()
    off = ipm.solve_batch_rescued(specs, cfg, W0)
    assert trace.take() == ([], {})
    on, spans, counters, _, _ = _traced(
        lambda: ipm.solve_batch_rescued(specs, cfg, W0))
    assert spans and counters["ipm.iters"] > 0
    for a, b in zip(_fields(off), _fields(on)):
        assert torch.equal(a, b)
    assert {s.request for s in spans} == {7}


def _nav_batch():
    base = nav.nav_spec(N=24, Ts=0.45, device="cpu")
    return _shifted(base, (-0.2, 0.2), axis=1), nav


@pytest.mark.parametrize("family", ["parking", "nav"])
def test_span_tree_and_counters(parking, family, monkeypatch):
    if family == "parking":
        specs, prob = parking[2], nlp
        W0, cfg = parking[3], f32_solver_config()
    else:
        (specs, prob), W0 = _nav_batch(), None
        cfg = SolverConfig(max_iter=4)
    calls = _count_steps(monkeypatch)
    res, spans, counters, t0, t1 = _traced(
        lambda: ipm.solve_batch(specs, cfg, W0, prob=prob))
    _check_tree(spans, t0, t1)
    names = Counter(s.name for s in spans)
    B = specs.x0.shape[0]
    assert names["ipm.solve"] == 1 and spans[0].name == "ipm.solve"
    turns = len(calls)
    assert turns == names["ipm.iter"] == counters["ipm.iters"] > 0
    assert counters["ipm.lane_slots"] == B * turns
    assert int(res.iters.max()) <= turns
    for i, sp in enumerate(spans):
        if sp.name == "ipm.iter":
            kids = Counter(s.name for s in _children(spans, i))
            assert kids["ipm.assemble"] == kids["ipm.update"] == 1
            assert kids["ipm.sync"] == 1 and kids["kkt.solve"] == 1
        if sp.name == "ipm.assemble":
            assert [s.name for s in _children(spans, i)] == [
                "nlp.constraint_blocks"]
        if sp.name == "kkt.solve":
            assert [s.name for s in _children(spans, i)] == [
                "kkt.factor", "kkt.refine"]
    # The least-squares dual init solves once, in set-up; with SOC on,
    # every iteration solves once more under ipm.soc.
    soc = names["ipm.iter"] if cfg.soc else 0
    assert names["kkt.solve"] == 1 + names["ipm.iter"] + soc


def test_rescue_rounds_and_lanes(monkeypatch):
    """The starved lane of ``test_rescue_reseeds_a_starved_lane``: one
    ``ipm.rescue`` per round that runs, each holding one ``ipm.solve``
    over the failed lanes, which ``ipm.rescue_lanes`` counts."""
    base = reverse_parking_spec(N=40, Ts=0.6, device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(base)
    specs = _shifted(base, (-0.05, 0.0, 0.05))
    W0 = geometric.lattice_warm_start(specs, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    W0[1, :, 4:] = 0.0
    cfg = SolverConfig(max_iter=45)
    runs = []
    run = ipm._run

    def counted_run(specs_, *a, **kw):
        runs.append(specs_.x0.shape[0])
        return run(specs_, *a, **kw)

    monkeypatch.setattr(ipm, "_run", counted_run)
    res, spans, counters, t0, t1 = _traced(
        lambda: ipm.solve_batch_rescued(specs, cfg, W0))
    _check_tree(spans, t0, t1)
    rounds = runs[1:]
    assert rounds and rounds[0] == 2      # lanes 1 and 2 fail pass 1
    rescues = [i for i, s in enumerate(spans) if s.name == "ipm.rescue"]
    assert len(rescues) == len(rounds)
    assert counters["ipm.rescue_lanes"] == sum(rounds)
    for i in rescues:
        assert [s.name for s in _children(spans, i)] == ["ipm.sync",
                                                         "ipm.solve"]
    assert (res.status == ipm.STATUS_CONVERGED).sum() >= 2


def test_mpc_fleet_plan_and_periods(parking):
    _, _, specs, W0 = parking
    one = tspec.take(specs, slice(1, 2))
    cfg = f32_solver_config(max_iter=40)
    out, spans, _, t0, t1 = _traced(
        lambda: mpc.run_fleet(one, cfg, 2, W0[1:2].float(),
                              resolve_max_iter=20))
    _check_tree(spans, t0, t1)
    top = [(i, s.name) for i, s in enumerate(spans) if s.parent == -1]
    assert [n for _, n in top] == ["mpc.plan", "mpc.period", "mpc.period"]
    for i, _ in top:
        assert "ipm.solve" in [s.name for s in _children(spans, i)]
    assert out.status.shape == (1, 2)


def test_warm_start_spans_and_recorder(parking):
    base, lcfg, specs, _ = parking
    _, spans, counters, t0, t1 = _traced(
        lambda: geometric.lattice_warm_start(
            specs, cfg=lcfg, field=lattice.plan_field(base, lcfg)),
        request="r1")
    _check_tree(spans, t0, t1)
    assert [s.name for s in spans] == ["warmstart.plan_field",
                                       "warmstart.lattice"]
    assert [s.request for s in spans] == ["r1", "r1"] and counters == {}
    # Off: one shared no-op context manager, counters untouched.
    assert trace.span("a") is trace.span("b")
    trace.count("x", 3)
    assert trace.take() == ([], {})
    trace.enable()
    with trace.span("outer"):
        with pytest.raises(RuntimeError):
            trace.take()


def test_recorder_adds_no_host_read(parking, monkeypatch):
    """The same count of ``Tensor.__bool__``, ``item``, ``tolist`` and
    ``cpu`` calls during a solve with the recorder on and off."""
    _, _, specs, W0 = parking
    reads = Counter()

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads[name] += 1
            return orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, read)

    for name in ("__bool__", "item", "tolist", "cpu"):
        counting(name)
    cfg = f32_solver_config()
    ipm.solve_batch_rescued(specs, cfg, W0)
    off = dict(reads)
    reads.clear()
    _traced(lambda: ipm.solve_batch_rescued(specs, cfg, W0))
    assert off["__bool__"] > 0 and dict(reads) == off
