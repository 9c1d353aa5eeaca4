"""Runs one cell once: set-up, warm-up, the measured window of whole
requests, the reading of its metrics, and the comparison that decides
``correct``; prints the result as the last line of standard output.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the workload's configuration file, its traffic mix
(``portbench/traffic/<traffic>.json``), the limits of its comparison
(``portbench/limits/<workload>.json``) and one reader a metric
(``portbench/metrics/<metric>.py``, whose ``read(run)`` returns the
metric's value or None where the run holds nothing to read).

The window: requests start one after another while less than
``--seconds`` have passed since the first started; every request that
started runs to its end and counts, and the window ends with the last.
Rates and times per period are over the window so measured.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "obca_tpu")
# The warm-up request's iteration cap: every shape of the cell's
# requests is run once, and no solve runs to convergence.
WARM_ITERS = 3


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench, name, overrides=None):
    """(workload entry, configuration, traffic mix, limits) of a cell;
    ``overrides`` {"config": {...}, "traffic": {...}} is merged into the
    configuration and the mix (tests at small sizes)."""
    hits = [w for w in bench["workloads"] if w["name"] == name]
    if not hits:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    wl = hits[0]
    conf = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    cfg.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("traffic", {}))
    return wl, cfg, mix, load_json(HERE / "limits" / f"{name}.json")


def metrics_of(bench, name, trace):
    """The metric entries a cell reports: its per-layer metrics in a
    traced run, its end-to-end metrics otherwise."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def reader(metric):
    """``read`` of the metric's reader module."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a reader may read of one run.

    ``kind`` ("sweep" or "mpc"), ``cfg`` and ``mix``; ``setup_s`` and
    ``window_s`` (host clock); ``requests``: per request {"lanes",
    "converged", "iters" (numpy, per lane: pass 1 plus rescue)};
    ``periods``: per maneuver {"iters", "status"} (numpy [lanes,
    periods]); ``seconds``: host seconds under each harness span
    ("warmstart", "solve", "mpc"); ``launches``: the program's kernel
    launches in the window; ``factor_calls``: the shape (B, S, nz, nnz,
    C) of every call of the factor kernel (traced runs); ``trace``: the
    reduced device trace of the window (``yardstick.reduce_trace``;
    traced runs), else None."""

    def __init__(self, **kw):
        self.requests, self.periods = [], []
        self.factor_calls, self.trace = [], None
        self.__dict__.update(kw)


def _cpu(t):
    return t.detach().cpu()


def _solve_record(res):
    return {"W": _cpu(res.W), "nu": _cpu(res.nu), "zL": _cpu(res.duals.zL),
            "zU": _cpu(res.duals.zU), "status": _cpu(res.status)}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start=None, device=None, overrides=None):
    """Run one cell once.  ``device``: None requires as many CUDA cards
    as the cell asks for; tests pass a CPU device.  ``overrides``:
    {"config": {...}, "traffic": {...}} merged into the cell's files
    (tests at small sizes).  Returns the exit code."""
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    bench = benchmark()
    wl, cfg, mix, limits = cell(bench, args.workload, overrides)
    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < wl["chips"]:
            print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                  f"found {have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    # One host thread drives the program, as one process a card would;
    # the reference's check after the window takes a few.
    torch.set_num_threads(1)
    out = measure(bench, wl, cfg, mix, limits, args, device, t_start)
    if out is None:
        return 1
    print(json.dumps(out), flush=True)
    return 0


def warm_up(prog, mix, seed):
    """Request 0 of the seed at the cell's shapes, every solve capped at
    WARM_ITERS iterations (one control period for a maneuver)."""
    from portbench import program, traffic

    x0 = prog.starts(traffic.start_poses(mix, prog.cfg["x0"], seed, 0))
    spans = program.Spans(prog.device)
    if mix["kind"] == "sweep":
        prog.sweep(mix, x0, spans, max_iter=WARM_ITERS)
    else:
        prog.maneuver(mix, x0, spans, plan_max_iter=WARM_ITERS, periods=1,
                      resolve_max_iter=WARM_ITERS)
    program.sync(prog.device)


def factor_launches():
    from portbench import program

    return program.launches().get("factor_se", 0)


def window(prog, mix, seed, seconds, spans):
    """Requests 1, 2, ... of the seed while less than ``seconds`` have
    passed since the first started.  Returns (raw results, start ns,
    end ns)."""
    from portbench import traffic

    raw = []
    t0 = time.time_ns()
    i = 1
    while True:
        x0 = prog.starts(traffic.start_poses(mix, prog.cfg["x0"], seed, i))
        run = prog.sweep if mix["kind"] == "sweep" else prog.maneuver
        n = factor_launches()
        t = time.time_ns()
        raw.append((x0,) + run(mix, x0, spans))
        spans.requests.append((t, time.time_ns(), factor_launches() - n))
        i += 1
        if time.time_ns() - t0 >= seconds * 1e9:
            return raw, t0, time.time_ns()


def collect(kind, raw, run):
    """The window's results on the CPU, as the check reads them, with
    the counts a reader reads added to ``run``.  Returns (records,
    attempted, failed)."""
    records = []
    attempted = failed = 0
    for x0, W0, res, *rest in raw:
        if kind == "sweep":
            rec = {"x0": _cpu(x0), "W0": _cpu(W0), **_solve_record(res)}
            st = rec["status"].numpy()
            run.requests.append({"lanes": st.size,
                                 "converged": int((st == 0).sum()),
                                 "iters": _cpu(res.iters).numpy()})
        else:
            (log,) = rest
            rec = {"x0": _cpu(x0), "W0": _cpu(W0),
                   "plan": _solve_record(log["plan"]),
                   "resolves": [_solve_record(r) for r in log["resolves"]],
                   "states": _cpu(res.states), "controls": _cpu(res.controls)}
            st = _cpu(res.status).numpy()
            run.periods.append({"iters": _cpu(res.iters).numpy(),
                                "status": st})
        attempted += st.size
        failed += int((st != 0).sum())
        records.append(rec)
    return records, attempted, failed


def readings(cfg, kind, records, lower=None):
    from portbench import check

    return (check.sweeps if kind == "sweep" else check.maneuvers)(
        cfg, records, lower)


def measure(bench, wl, cfg, mix, limits, args, device, t_start):
    import torch

    from portbench import check, program, yardstick

    kind = mix["kind"]
    prog = program.Program(cfg, device)
    warm_up(prog, mix, args.seed)
    # What set-up made stays: keep the collector from walking it again
    # in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start

    before = program.launches()
    spans = program.Spans(device)
    prof = nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA
                                   if device.type == "cuda"
                                   else ProfilerActivity.CPU])
    shapes = program.FactorShapes() if args.trace else nullcontext()
    with prof, shapes:
        raw, t0, t1 = window(prog, mix, args.seed, args.seconds, spans)
    launched = {k: v - before.get(k, 0) for k, v in
                program.launches().items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded in a run: {found}",
              file=sys.stderr)
        return None

    run = Run(kind=kind, cfg=cfg, mix=mix, setup_s=setup_s,
              window_s=(t1 - t0) / 1e9, seconds=dict(spans.seconds),
              launches=launched,
              factor_calls=list(getattr(shapes, "calls", [])))
    if args.trace:
        run.trace = yardstick.reduce_trace(
            yardstick.device_events(prof), t0, t1, spans.spans)
    records, attempted, failed = collect(kind, raw, run)
    del raw, prog
    if device.type == "cuda":
        torch.cuda.empty_cache()

    entries = metrics_of(bench, wl["name"], args.trace)
    metrics = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    torch.set_num_threads(4)
    values = readings(cfg, kind, records)
    correct, rows = check.judge(values, limits)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {n: {"value": v if math.isfinite(v) else str(v),
                         "limit": lim} for n, v, lim in rows}
    walls = [round((e - s) / 1e9, 4) for s, e, _ in spans.requests]
    per_iter = [round((e - s) / 1e6 / n, 2) if n else None
                for s, e, n in spans.requests]
    print(f"requests: {len(walls)}, seconds each: {walls}", file=sys.stderr)
    print(f"ms per factor launch, each request: {per_iter}", file=sys.stderr)
    for n, v, lim in rows:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    return out
