"""Long horizons: cyclic reduction against sequential block elimination.

    python3 -m obca_torch.tools.bench_cyclic [--nw 7] [--nc 6] [--batch 8]
        [--sizes 81 161 321 641 1281]

Port of ``tools/bench_cyclic.py``.  On random quasidefinite
block-tridiagonal systems of growing stage count S (the KKT structure
the IPM produces), for each S:

- float32: ``cyclic.factor`` + ``cyclic.solve`` against the hand-written
  dense block-Thomas kernels (``blocktri_dense.factor_dense`` +
  ``solve_dense``, the sequential route on the card);
- float64: the same cyclic reduction against the plain sequential
  ``blocktri.factor`` + ``blocktri.solve``, with the residual
  max |T x - r| of the cyclic solution.

It prints one JSON row per S (CUDA-event times of each route: the
median of three runs after the checked one, apart from the plain
float64 sequential solve, seconds long at S = 641, which is timed by its
checked run alone; their speedups, the relative differences, the
residual and the peak device memory) and then the verdict line, as the
JAX tool does; the verdict reads the float32 rows.  It runs on the card;
``main(..., device="cpu")`` runs the same steps (the kernels' plain
versions) on the CPU and reports no times or memory.

The systems follow the JAX tool's ``_random_qd`` (``A = R R'/nw + I``,
``D = -(Q Q'/nc + I)``, a N(0, 1) primal-dual block) with the coupling
E = 0.2 sqrt(13 / nz) N(0, 1): the JAX tool's 0.2 at its default nz =
13, scaled so that E's norm does not grow with nz.  At 0.2 and nz = 56,
E's norm is about three times the diagonal's smallest eigenvalue, the
matrix is no longer quasidefinite and every pivot-free factor loses
accuracy with S.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from obca_torch._util import resolve_device
from obca_torch.solver import blocktri, cyclic
from obca_torch.solver.kernels import blocktri_dense as bd

RUNS = 3   # timed runs of each route but the f64 sequential one


def random_qd(rng, S, nw, nc, B):
    """K [B, S, nz, nz], E [B, S-1, nz, nz], r [B, S, nz], float64
    numpy."""
    nz = nw + nc
    R = rng.standard_normal((B, S, nw, nw))
    A = R @ np.swapaxes(R, -1, -2) / nw + np.eye(nw)
    Q = rng.standard_normal((B, S, nc, nc))
    D = -(Q @ np.swapaxes(Q, -1, -2) / nc + np.eye(nc))
    Bm = rng.standard_normal((B, S, nw, nc))
    K = np.zeros((B, S, nz, nz))
    K[:, :, :nw, :nw] = A
    K[:, :, :nw, nw:] = Bm
    K[:, :, nw:, :nw] = np.swapaxes(Bm, -1, -2)
    K[:, :, nw:, nw:] = D
    E = 0.2 * np.sqrt(13.0 / nz) * rng.standard_normal((B, S - 1, nz, nz))
    r = rng.standard_normal((B, S, nz))
    return K, E, r


def _timed(fn, device, runs=RUNS):
    """(the last result of ``fn()``, the median CUDA-event time of
    ``runs`` runs; None off the card)."""
    cuda = device.type == "cuda"
    times = []
    for _ in range(runs):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        out = fn()
        if cuda:
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
    return out, (statistics.median(times) if cuda else None)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def measure_size(rng, S, nw, nc, B, device):
    """One row: both precisions' checks and times at stage count S."""
    nz = nw + nc
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    K, E, r = (torch.tensor(a, device=device)
               for a in random_qd(rng, S, nw, nc, B))

    def cr():
        return cyclic.solve(cyclic.factor(K, E, nw), r)

    def seq():
        return blocktri.solve(blocktri.factor(K, E, nw), r)

    K32, E32, r32 = (t.float().contiguous() for t in (K, E, r))

    def cr32():
        return cyclic.solve(cyclic.factor(K32, E32, nw), r32)

    def dense32():
        Sinv, W = bd.factor_dense(K32, E32)
        return bd.solve_dense(Sinv, W, E32, r32)

    # The checked runs (which warm every route up), then the timed ones.
    x_cr, x_cr32, x_d32 = cr(), cr32(), dense32()
    x_seq, seq_ms = _timed(seq, device, runs=1)
    row = {
        "S": S, "batch": B, "nz": nz,
        "dense_kernels_f32_ms": _timed(dense32, device)[1],
        "cyclic_f32_ms": _timed(cr32, device)[1],
        "sequential_f64_ms": seq_ms,
        "cyclic_f64_ms": _timed(cr, device)[1],
        "rel_diff_f32": _rel(x_cr32, x_d32),
        "rel_diff_f64": _rel(x_cr, x_seq),
        "residual_f64": float(
            (blocktri.matvec(K, E, x_cr) - r).abs().max()),
        "finite": bool(torch.isfinite(x_cr32).all()
                       and torch.isfinite(x_cr).all()),
    }
    for tag, base, new in (("", "dense_kernels_f32_ms", "cyclic_f32_ms"),
                           ("_f64", "sequential_f64_ms", "cyclic_f64_ms")):
        row["speedup" + tag] = (row[base] / row[new] if cuda else None)
    row["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                          if cuda else None)
    row["device"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    return row


def verdict(rows):
    """The JAX tool's crossover statement over the rows' ``speedup``:
    the winning band and whether the largest tested S wins."""
    if any(r["speedup"] is None for r in rows):
        return "not measured (no device)"
    wins = [r["S"] for r in rows if r["speedup"] > 1.0]
    if not wins:
        return ("sequential kernels faster at every tested S -- N=80 "
                "stays on the sequential path")
    if rows[-1]["speedup"] > 1.0 and all(
            r["speedup"] > 1.0 for r in rows if r["S"] >= wins[0]):
        return f"cyclic reduction wins from S >= {wins[0]}"
    best = max(rows, key=lambda r: r["speedup"])
    return (f"cyclic wins only in a narrow band (S in {wins}, best "
            f"{best['speedup']:.2f}x at S={best['S']}) and loses in the "
            f"long-horizon regime it exists for "
            f"({rows[-1]['speedup']:.2f}x at S={rows[-1]['S']}) -- "
            "sequential block elimination is the production path")


def main(nw=7, nc=6, batch=8, sizes=(81, 161, 321, 641, 1281),
         device="cuda"):
    """Print one JSON row per S and the verdict line; returns (rows,
    verdict)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    with torch.no_grad():
        for S in sizes:
            rows.append(measure_size(rng, S, nw, nc, batch, device))
            print(json.dumps(rows[-1]), flush=True)
    v = verdict(rows)
    print(json.dumps({"verdict": v}))
    return rows, v


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--nw", type=int, default=7)
    ap.add_argument("--nc", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[81, 161, 321, 641, 1281])
    args = ap.parse_args()
    main(args.nw, args.nc, args.batch, tuple(args.sizes))
