"""The system under test, driven through its public entry points: the
port ``obca_torch`` (warm starts, the rescued batched solve, the
closed-loop MPC), and the program counters the harness reads from it.

A configuration's ``family`` names the file of its base problem's
builder (``portbench/families/<family>.py``, whose ``base_spec(cfg,
device, dtype)`` calls the program's own builder); its ``solver`` names
the route (``obca_torch.<route>_solver_config``).  A mix's
``warm_start`` names the file of its warm start
(``portbench/warmstarts/<name>.py``, ``warm_start(prog, specs,
dtype)``).  A request hands the program start poses, made by the
traffic generator, and nothing else.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host spans (name, start ns, end ns) on the clock of the profiler's
    trace, each ended by a synchronize, the seconds spent under each
    name, and the (start ns, end ns, factor launches) of each request."""

    def __init__(self, device):
        self.device = device
        self.spans = []
        self.seconds = {}
        self.requests = []

    def run(self, name, fn, *args, **kw):
        t0 = time.time_ns()
        out = fn(*args, **kw)
        sync(self.device)
        t1 = time.time_ns()
        self.spans.append((name, t0, t1))
        self.seconds[name] = self.seconds.get(name, 0.0) + (t1 - t0) / 1e9
        return out


class FactorShapes:
    """Records the shape (B, S, nz, nnz, C) of every call of the factor
    kernel's wrapper while passing the call through."""

    def __init__(self):
        from obca_torch.solver.kernels import blocktri_se

        self.bk = blocktri_se
        self.calls = []
        self._factor = blocktri_se.factor_se

    def __enter__(self):
        def factor(K, ev, reg, pat):
            B, S, nz, _ = K.shape
            self.calls.append((B, S, nz, len(pat.rows), len(pat.ucols)))
            return self._factor(K, ev, reg, pat)

        self.bk.factor_se = factor
        return self

    def __exit__(self, *exc):
        self.bk.factor_se = self._factor


def launches():
    """The program's own count of kernel launches, by kernel."""
    from obca_torch.solver.kernels import runtime

    return dict(runtime.launches)


def solver_config(cfg, max_iter):
    """The configuration's solver route at cap ``max_iter``."""
    import obca_torch as ot

    kw = {k: v for k, v in cfg["solver"].items() if k != "route"}
    make = getattr(ot, f"{cfg['solver']['route']}_solver_config")
    return make(max_iter=max_iter, **kw)


def base_spec(cfg, device):
    """(problem module, base problem) of the configuration, built by its
    family's file in the configuration's iterate precision."""
    fam = importlib.import_module(f"portbench.families.{cfg['family']}")
    return fam.base_spec(cfg, device, DTYPES[cfg["precision"]["iterate"]])


def batch(base, x0):
    """The base problem repeated over the lanes of start poses x0
    [lanes, 4] (already in the problem's precision)."""
    from obca_torch import spec as tspec

    lanes = x0.shape[0]
    return dataclasses.replace(tspec.stack([base] * lanes), x0=x0)


class Program:
    """One configuration of the program on one device."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = device
        self.prob, self.base = base_spec(cfg, device)
        self.dtype = self.base.x0.dtype

    def starts(self, x0):
        """Start poses (float64 numpy) in the program's precision, on
        the device."""
        return torch.as_tensor(x0, device=self.device).to(self.dtype)

    def warm_start(self, mix, specs, dtype):
        """The mix's warm start of every lane, by its file."""
        ws = importlib.import_module(
            f"portbench.warmstarts.{mix['warm_start']}")
        return ws.warm_start(self, specs, dtype)

    def sweep(self, mix, x0, spans, max_iter=None):
        """One sweep request: warm starts, then the rescued batched solve
        of every lane.  Returns (W0, SolveResult)."""
        from obca_torch.solver import ipm

        specs = batch(self.base, x0)
        cfg = solver_config(self.cfg, max_iter or mix["max_iter"])
        W0 = spans.run("warmstart", self.warm_start, mix, specs, cfg.dtype)
        res = spans.run("solve", ipm.solve_batch_rescued, specs, cfg, W0,
                        prob=self.prob, rescue_mu=mix["rescue_mu"],
                        rescue_rounds=mix["rescue_rounds"])
        return W0, res

    def maneuver(self, mix, x0, spans, plan_max_iter=None, periods=None,
                 resolve_max_iter=None):
        """One closed-loop maneuver of the lanes of x0: warm starts, then
        ``mpc.run_fleet`` (the rescued initial plans and ``periods``
        control periods).  Returns (W0, MpcResult, record) where record
        holds each solve the loop made: the initial plans ("plan") and one
        re-solve a period ("resolves")."""
        from obca_torch import mpc
        from obca_torch.solver import ipm

        specs = batch(self.base, x0)
        cfg = solver_config(self.cfg, plan_max_iter or mix["plan_max_iter"])
        W0 = spans.run("warmstart", self.warm_start, mix, specs, cfg.dtype)
        record = {"plan": None, "resolves": []}
        rescued, plain = ipm.solve_batch_rescued, ipm.solve_batch
        inside = []

        def rescued_rec(specs_, cfg_, W0_=None, *a, **kw):
            inside.append(True)
            try:
                res = rescued(specs_, cfg_, W0_, *a, **kw)
            finally:
                inside.pop()
            record["plan"] = res
            return res

        def plain_rec(specs_, cfg_, W0_=None, *a, **kw):
            res = plain(specs_, cfg_, W0_, *a, **kw)
            if not inside:
                record["resolves"].append(res)
            return res

        ipm.solve_batch_rescued, ipm.solve_batch = rescued_rec, plain_rec
        try:
            out = spans.run(
                "mpc", mpc.run_fleet, specs, cfg,
                periods or mix["periods"], W0,
                resolve_mu=mix["resolve_mu"],
                resolve_max_iter=resolve_max_iter or mix["resolve_max_iter"],
                resolve_tol=mix["resolve_tol"])
        finally:
            ipm.solve_batch_rescued, ipm.solve_batch = rescued, plain
        return W0, out, record

