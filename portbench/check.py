"""The comparison that decides ``correct``: every answer the window's
requests returned, judged by the configuration's plain reference.

Numbers compared (each the largest over every lane or solve checked):

- ``pri``, ``stat``, ``comp``: the float64 KKT readings of every lane
  the program reports converged (``reference.common.kkt_readings``):
  the plan satisfies the dynamics, boundary conditions, obstacle rows,
  rate rows and bounds, and is a stationary point of the problem's
  Lagrangian with the multipliers the solver returned.
- ``clear``: d_min minus the exact distance of the ego to the nearest
  obstacle along every converged plan (and, for a maneuver, along the
  states the vehicle passed through).
- ``ws``: the warm start of every lane against what the warm-start
  stage promises (start and goal, boxes, the dual warm start of its own
  poses; ``warm_start_gap`` of the family).
- ``loop`` (maneuvers): every closed-loop state against the plant
  driven by the control applied before it, and every control applied
  after a converged re-solve against that plan's first control.

``lower`` rounds every output of the program (not the start poses the
harness gave it) to a lower precision before it is judged: the control
that has to come out as not correct.
"""

from __future__ import annotations

import importlib
import math

import torch

BLOCK = 1024


def reference(cfg):
    """The configuration's plain reference module."""
    return importlib.import_module(
        f"portbench.reference.{cfg['reference']}")


def rounded(a, dtype):
    """``a`` (a CPU tensor) as ``dtype`` would hold it, in float64."""
    if dtype is None or not isinstance(a, torch.Tensor) \
            or not a.is_floating_point():
        return a
    return a.to(dtype).to(torch.float64)


class Readings:
    def __init__(self, names):
        self.values = {n: -math.inf for n in names}

    def add(self, name, t):
        if t.numel():
            self.values[name] = max(self.values[name],
                                    float(t.max().nan_to_num(math.inf)))

    def fail(self, name):
        self.values[name] = math.inf


def _kkt(ref, cfg, x0, u_prev, W, nu, zL, zU, out):
    """The KKT and clearance readings of the lanes of one solve, in
    blocks of lanes."""
    from portbench.reference.common import kkt_readings

    for a in range(0, W.shape[0], BLOCK):
        sl = slice(a, a + BLOCK)
        p = ref.problem(cfg, x0[sl], None if u_prev is None else u_prev[sl])
        r = kkt_readings(ref, p, W[sl], nu[sl], zL[sl], zU[sl])
        for k, v in r.items():
            out.add(k, v)
        out.add("clear", ref.clearance_gap(p, W[sl][..., :4]))


def sweeps(cfg, records, lower=None):
    """Readings of sweep requests: records of {x0, W0, W, nu, zL, zU,
    status} (CPU tensors; x0 as the program was given it)."""
    ref = reference(cfg)
    out = Readings(("pri", "stat", "comp", "clear", "ws"))
    eps = float(cfg["dual_eps"])
    for rec in records:
        r = {k: rounded(v, lower) for k, v in rec.items() if k != "x0"}
        x0 = rec["x0"].double()
        for a in range(0, x0.shape[0], BLOCK):
            sl = slice(a, a + BLOCK)
            out.add("ws", ref.warm_start_gap(ref.problem(cfg, x0[sl]),
                                             r["W0"][sl], eps))
        ok = r["status"] == 0
        if bool(ok.any()):
            _kkt(ref, cfg, x0[ok], None, r["W"][ok], r["nu"][ok],
                 r["zL"][ok], r["zU"][ok], out)
    return out.values


def maneuvers(cfg, records, lower=None):
    """Readings of closed-loop maneuvers: records of {x0, W0, plan
    (dict of W, nu, zL, zU, status), resolves (list, one a period, of
    such dicts), states, controls}."""
    ref = reference(cfg)
    out = Readings(("pri", "stat", "comp", "clear", "ws", "loop"))
    eps = float(cfg["dual_eps"])
    for rec in records:
        rnd = lambda v: rounded(v, lower)  # noqa: E731
        x0 = rec["x0"].double()
        states, controls = rnd(rec["states"]), rnd(rec["controls"])
        T = controls.shape[1]
        p0 = ref.problem(cfg, x0)
        out.add("ws", ref.warm_start_gap(p0, rnd(rec["W0"]), eps))
        plan = {k: rnd(v) for k, v in rec["plan"].items()}
        ok = plan["status"] == 0
        if bool(ok.any()):
            _kkt(ref, cfg, x0[ok], None, plan["W"][ok], plan["nu"][ok],
                 plan["zL"][ok], plan["zU"][ok], out)
        if len(rec["resolves"]) != T:
            out.fail("loop")
            continue
        out.add("loop", (states[:, 0] - x0).abs())
        out.add("loop", ref.plant_gap(p0, states, controls))
        out.add("clear", ref.clearance_gap(p0, states))
        for t, solve in enumerate(rec["resolves"]):
            s = {k: rnd(v) for k, v in solve.items()}
            ok = s["status"] == 0
            if not bool(ok.any()):
                continue
            u_prev = (torch.zeros_like(controls[:, 0]) if t == 0
                      else controls[:, t - 1])
            _kkt(ref, cfg, states[ok, t], u_prev[ok], s["W"][ok],
                 s["nu"][ok], s["zL"][ok], s["zU"][ok], out)
            out.add("loop", (controls[ok, t] - s["W"][ok, 0, 4:6]).abs())
    return out.values


def judge(values, limits):
    """(correct, [(name, value, limit)]): every number the cell's limits
    name at or under its limit; a number never read (no lane converged)
    fails."""
    rows = [(n, values[n], float(limits[n])) for n in sorted(limits)]
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows), rows
