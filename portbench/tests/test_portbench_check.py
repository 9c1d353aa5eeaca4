"""The comparison that decides ``correct``, on the CPU at a small size:
the plain reference accepts the program's answers, and rejects the
control (the same answers in the next lower precision) and a run whose
timed path is broken underneath."""

import json
import math

import pytest
import torch

from portbench import check, control, harness

CPU = torch.device("cpu")
SMALL = {
    "reverse_sweep_b128": {"config": {"N": 20, "Ts": 1.2},
                           "traffic": {"lanes": 4}},
    "reverse_mpc_b1": {"config": {"N": 20, "Ts": 1.2},
                       "traffic": {"periods": 3}},
    "nav_sweep_b128": {"config": {"N": 20, "Ts": 0.75},
                       "traffic": {"lanes": 4}},
}


def run(capsys, cell, seed=2 ** 31 + 7):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0", "--trace", "0"], device=CPU,
                      overrides=SMALL[cell])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_is_correct_and_control_is_not(capsys, cell):
    control.main(["--workload", cell, "--seconds", "0", "--seeds", "11"],
                 device=CPU, overrides=SMALL[cell])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = row["limits"]
    assert check.judge(row["program"], limits)[0], row
    assert not check.judge(row["control"], limits)[0], row
    # At this size feasibility already separates the two (at the cell's
    # own size every number does: PERF.md gives the readings).
    assert row["control"]["pri"] > limits["pri"] >= row["program"]["pri"]


def test_result_line(capsys):
    out = run(capsys, "reverse_sweep_b128")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] == 4
    assert set(out["metrics"]) == {"converged_solves_per_s", "setup_s"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def _patch_sweep(monkeypatch, fault):
    from obca_torch.solver import ipm

    real = ipm.solve_batch_rescued

    def broken(specs, cfg, W0=None, **kw):
        res = real(specs, cfg, W0, **kw)
        if fault == "unchanged":
            return res._replace(W=W0.clone())
        if fault == "half":
            B = res.W.shape[0]
            keep = torch.arange(B) % (B // 2)
            return ipm.SolveResult(*[
                f[keep] if isinstance(f, torch.Tensor) and f.shape[:1] == (B,)
                else f for f in res[:-1]], duals=ipm.DualState(
                    *[t[keep] for t in res.duals.__dict__.values()]))
        W = res.W.clone()
        W[0, 3, 4] += 0.01          # one steering input altered
        return res._replace(W=W)

    monkeypatch.setattr(ipm, "solve_batch_rescued", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_sweep_is_not_correct(capsys, monkeypatch, fault):
    _patch_sweep(monkeypatch, fault)
    out = run(capsys, "reverse_sweep_b128")
    assert out["correct"] is False, out["checks"]


def test_non_stationary_nav_is_not_correct(capsys, monkeypatch):
    """A nav answer that is feasible, from its own warm start, but whose
    multipliers are off by 1%: only stationarity and complementarity
    can see it (feasibility and the warm start read as in a sound run)."""
    from obca_torch.solver import ipm

    real = ipm.solve_batch_rescued

    def broken(specs, cfg, W0=None, **kw):
        res = real(specs, cfg, W0, **kw)
        return res._replace(nu=res.nu * 1.01)

    monkeypatch.setattr(ipm, "solve_batch_rescued", broken)
    out = run(capsys, "nav_sweep_b128")
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["pri"]["value"] <= out["checks"]["pri"]["limit"]
    assert out["checks"]["stat"]["value"] > out["checks"]["stat"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_broken_maneuver_is_not_correct(capsys, monkeypatch, fault):
    from obca_torch.solver import ipm

    real = ipm.solve_batch

    def broken(specs, cfg, W0=None, *a, **kw):
        res = real(specs, cfg, W0, *a, **kw)
        if fault == "unchanged":
            return res._replace(W=W0.clone(), X=W0[..., :4],
                                U=W0[:, :-1, 4:6])
        W = res.W.clone()
        W[:, 0, 4] += 0.01
        return res._replace(W=W, U=W[:, :-1, 4:6])

    monkeypatch.setattr(ipm, "solve_batch", broken)
    out = run(capsys, "reverse_mpc_b1")
    assert out["correct"] is False, out["checks"]


def test_no_converged_lane_is_not_correct():
    values = {"pri": -math.inf, "ws": 0.0}
    assert not check.judge(values, {"pri": 1.0, "ws": 1.0})[0]
