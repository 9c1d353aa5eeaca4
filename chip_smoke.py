#!/usr/bin/env python3
"""Smoke test of obca_torch on one CUDA GPU: build, check, run, measure.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits
non-zero, and no result line is printed):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every CUDA kernel source in ``obca_torch/solver/kernels/csrc``
   (one nvcc per source, in parallel) and print the build seconds;
3. each of the seven kernels against its plain PyTorch version on the
   card, at the main path's shapes (B=128, S=81, nz=56), on a
   well-conditioned random quasidefinite system from a numpy seed, with
   a genuinely dense coupling block for the dense-coupling kernels
   (relative error must be <= 1e-4), and the structured ones again on
   the real system of the main path's first IPM iteration (printed);
   median CUDA-event times over 25 runs each (the host's launch gap
   included) and each kernel's own device time per call (25 calls under
   torch.profiler);
3w. the seven kernels' wide instantiations (64 < nz <= 128) at nz = 72,
   the stage size of the topology-varied families, on the synthetic
   system with their coupling pattern (timed as in phase 3) and on its
   two interchange variants (rows permuted; leading pivot 1e-8), each
   output within 1e-4 relative of its plain version;
3b. the kernel bench's probe kernels against their plain versions: the
   stream kernel (out = x + 1) over the bench's [B, S, nz, nz] array
   and over an odd n from a 4-byte offset (both exact), the FMA probe
   within 2 units in the last place of each element of its plain
   version (which rounds each step as the kernel's fused multiply-add
   does), timed like phase 3 and beside PyTorch's x + 1;
   then the kernel bench (``obca_torch.tools.kernel_bench``) at B=128,
   N=80 with every launch count set to 0 just before it and read just
   after (both probes must have launched), printed as one
   ``kernel_bench`` JSON line, and each phase-3 kernel's bound at the
   stream and FMA rates the bench measured;
4. the f32 main path as ``bench.py`` builds it: 128 start-pose shifts of
   ``reverse_parking_spec(N=80, Ts=0.3)`` in float32, one shared
   ``lattice.plan_field``, per-lane ``geometric.lattice_warm_start`` and
   ``ipm.solve_batch_rescued`` under ``f32_solver_config(max_iter=55)``
   (rescue mu 1e-5) — one warm-up run, then one timed run between
   which every kernel's launch count is reset and read (its three
   kernels must have launched), and two more timed runs for the spread
   (the device's busy share and the kernels that take its time: the
   benchmark's ``reverse_sweep_b128`` cell with ``--trace 1``);
5. parity: the golden warm start of
   ``oracle/goldens/reverse_parking_N80.npz`` solved at B=1 under
   ``f32_solver_config()``; max |U - U_gold| must be < 1e-3;
6d. the dense-coupling solver ``kkt.make_kkt_solver`` against
   ``kkt.make_kkt_solver_se`` on the f32 first-iteration system (E built
   from the coupling values), launch counts reset just before: d must be
   finite and within 1e-3 relative, and the three dense kernels must
   have launched;
4m. the mixed-precision main path (``bench.py``'s ``BENCH_DTYPE=mixed``):
   the same batch in float64 under ``mixed_solver_config(max_iter=55)``,
   measured as in phase 4; ``factor_se``, ``fwd_se`` and ``bwd_se`` must
   have launched and ``bwd_matvec_se`` must not; one profiled run; then
   ``solve_se`` against its plain version on the captured
   first-iteration system;
5m. mixed parity: ``reverse_parking_N80`` under ``mixed_solver_config()``
   and ``reverse_parking_dist_N80`` (unsigned distance) under
   ``mixed_solver_config(max_iter=200)``; each gap must be < 1e-3;
7. the topology-varied reverse family at full width, as
   ``bench/run_sweep.py`` runs a shard:
   ``randomized_reverse_parking_specs(128, n_layouts=8, seed=0, N=80,
   Ts=0.3, vary_topology=True)`` in float32 (nz = 72), one plan field
   per layout on the static grid of the base spec,
   ``grouped_lattice_warm_start`` and ``solve_batch_rescued`` under
   ``f32_solver_config(max_iter=70)`` (rescue mu 1e-5) -- one warm-up
   run, the counted run (``factor_se``, ``fwd_se`` and ``bwd_matvec_se``
   must have launched), two more timed runs and one profiled run; at
   least 116 lanes must converge, and every converged lane must clear
   its own obstacles by d_min - 1e-3 at every stage and end within 1e-3
   of its own goal;
8p. the parallel family: the golden warm start of
   ``parallel_parking_N80`` under ``parallel_fastpath_config()`` (gap <
   1e-3), then ``randomized_parallel_parking_specs(32, n_layouts=4,
   seed=0)`` under ``f32_solver_config(max_iter=250, mu_init=1e-3,
   delta_w=1e-4)`` (``run_sweep.py --family parallel``), counted: at
   least 16 lanes converged, each passing the checks of phase 7;
8f. free time: ``reverse_parking_freetime_N80`` through
   ``ipm.solve_free_time`` under ``f32_solver_config(max_iter=250)``
   (gap < 1e-3; |tau - tau_gold| printed);
9. the MPC fleet, ``bench/run_mpc.py``'s defaults composed from port
   calls: 128 starts of ``reverse_parking_spec(N=80, Ts=0.3)`` in
   float32 shifted by ``uniform(-0.3, 0.3)`` draws, one ``plan_field``,
   per-lane ``lattice_warm_start``, ``mpc.run_fleet`` for 30 periods
   under ``f32_solver_config(max_iter=70)`` (re-solves: mu 1e-4, cap 60,
   tol 1e-3), counted (``factor_se``, ``fwd_se``, ``bwd_matvec_se``):
   initial plans 128/128, step convergence >= 0.90, every closed-loop
   state finite and clear of its obstacles by d_min - 1e-3
   (``geometry.ego_clearance_exact``, the exact polygon distance where
   that SAT gap is below), every rollout nearer its goal at the end;
9s. rollout 0 alone (B = 1) for 30 and for 10 periods: the per-period
   time a single vehicle sees and its steady slope (no gate); the
   ``factor_se``, ``fwd_se`` and ``bwd_matvec_se`` kernels against their
   plain versions (within 1e-4 relative) on a system of its period-2
   re-solve, captured in the warm-up run (the device's share of a
   period: the benchmark's ``reverse_mpc_b1`` cell with ``--trace 1``);
   then the single-vehicle entry point: rollout 0's ``mpc.run`` from
   its ``ipm.solve_single`` plan for 4 periods, counted (its three
   kernels must have launched), against ``mpc.run_fleet`` at B = 1 from
   the same warm start: the same plan and period statuses, and every
   closed-loop state within 1e-3;
10. the navigation family: 128 lanes of ``nav.nav_spec()`` (N=60, nz =
   44) on the grazing layout of ``tests/test_nav.py``, start y shifted
   by ``uniform(-0.4, 0.4)`` draws, ``ipm.solve_batch_rescued(...,
   prob=nav)`` under ``mixed_solver_config(max_iter=150)``, counted
   (``factor_se``, ``fwd_se``, ``bwd_se``) on the main path (its turns
   replayed as CUDA graphs): every converged lane within
   1e-5 of its boundary conditions and every stage point at least d_min
   - 1e-4 outside every obstacle, at least the JAX package's converged
   count less 3, and lane 0's controls within 1e-3 of the port's float64
   solve of the same spec on the CPU; an eager solve of the same batch
   equal to it bit for bit; ``factor_se``, ``fwd_se`` and ``bwd_se``
   against their plain versions (within 1e-4 relative) on the counted
   run's first-iteration system and on the eager solve's last one (a
   rescue round's, at fewer lanes, when one ran);
11. the f32 main path sharded: a one-rank NCCL group
   (``parallel.distributed.initialize`` on a free localhost port), its
   ``global_scenario_mesh`` and ``parallel.mesh.solve_sharded`` on phase
   4's batch from its lattice warm starts under
   ``f32_solver_config(max_iter=55)``, counted, with ``ipm.solve_batch``
   on the same inputs beside it: statuses and iterations equal, max |dU|
   <= 1e-5 (printed, with whether it is bitwise), the all-reduced metrics
   equal to the same reductions made here, the f32 route launched; the
   group is destroyed after;
11p. two worker processes over gloo on the one card (NCCL refuses two
   ranks on one GPU), each on its ``process_shard`` (64 lanes) of
   exactly phase 11's inputs, written to a temporary npz file: both
   ranks' reduced converged count equal to the union's, the reduced max
   error the larger rank's, the union's converged count at least phase
   11's less 2, U within 1e-3 of phase 11 on the lanes converged in
   both; a worker that fails, exits non-zero or outlives its timeout
   fails the phase;
12. cyclic reduction at the main path's width
   (``obca_torch.tools.bench_cyclic``, B=128, nz=56, S = 81, 321, 641):
   float64 within 1e-8 relative of the plain sequential ``blocktri``
   (residual printed), float32 within 1e-4 of the dense kernels
   (counted), the times of both, the peak memory and the verdict;
13. ``ipm.debug_iterate`` on the golden ``reverse_parking_N80`` warm
   start (B=1, ``f32_solver_config()``, 10 iterations): within 1e-6
   relative of 10 plain steps of the same ``_make_step`` (and whether
   bitwise), every diagnostic finite; its first and last lines printed;
6. one ``kernels`` JSON line (launches summed over the counted runs of
   phases 3b, 4, 6d, 4m, 7, 8p, 9, 9s, 10, 11, 11p (the workers' counts)
   and 12; each solver kernel's nz = 72 numbers from phase 3w beside its
   own), then the device line, last.

Each phase prints its seconds.

It imports nothing of JAX and nothing of ``obca_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

B_MAIN, N_MAIN, TS_MAIN, ITERS_MAIN = 128, 80, 0.3, 55
SYNTH_TOL = 1e-4
# Phase 7: bench/run_sweep.py's f32 defaults for the topology-varied
# reverse family; phase 8p: its parallel-family settings.
ITERS_RANDOM, RANDOM_MIN_CONVERGED, RANDOM_REPEATS = 70, 116, 3
B_PARALLEL, ITERS_PARALLEL, PARALLEL_MIN_CONVERGED = 32, 250, 16
LANE_TOL = 1e-3    # clearance below d_min and distance to xF allowed
PROBE_ULPS = 2
PARITY_TOL = 1e-3
DENSE_TOL = 1e-3
# Phase 9: bench/run_mpc.py's defaults (fleet, f32, N=80, Ts=0.3).
B_MPC, MPC_SPREAD, ITERS_MPC = 128, 0.3, 70
MPC_STEPS, MPC_STEPS_SHORT, MPC_RUN_STEPS = 30, 10, 4
RESOLVE_MU, RESOLVE_ITERS, RESOLVE_TOL = 1e-4, 60, 1e-3
MPC_MIN_STEP_CONV = 0.90
MPC_RUN_TOL = 1e-3
# Phase 10: the nav batch on tests/test_nav.py's grazing layout.
NAV_VERTS = [
    [(-4.0, 0.5), (-2.0, 0.5), (-2.0, 5.0), (-4.0, 5.0)],
    [(2.0, -5.0), (4.0, -5.0), (4.0, -0.5), (2.0, -0.5)],
]
B_NAV, NAV_SPREAD, ITERS_NAV = 128, 0.4, 150
NAV_BC_TOL, NAV_CLEAR_TOL, NAV_PARITY_TOL = 1e-5, 1e-4, 1e-3
# The JAX package's converged count on the same 128 lanes (float64 on a
# CPU: PYTHONPATH=. python tests/test_torch_nav.py); the port may
# converge NAV_COUNT_SLACK fewer.
NAV_JAX_CONVERGED, NAV_COUNT_SLACK = 128, 3
# Phase 11: the sharded f32 main path against solve_batch; 11p: two
# worker ranks over gloo, each given this long, may converge
# SHARD_COUNT_SLACK fewer lanes than phase 11 in all.
SHARD_U_TOL, SHARD_COUNT_SLACK, SHARD_WORKER_TIMEOUT = 1e-5, 2, 300
# Phase 12: cyclic reduction at the main path's width; phase 13: the
# debug iterate against the plain steps.
CR_SIZES, CR_TOL_F64 = (81, 321, 641), 1e-8
DEBUG_ITERS, DEBUG_TOL = 10, 1e-6
# The kernels each solver route runs.
F32_ROUTE = ("factor_se", "fwd_se", "bwd_matvec_se")
MIXED_ROUTE = ("factor_se", "fwd_se", "bwd_se")
_PALLAS = "obca_tpu/solver/pallas/blocktri_kernel.py"
# kernel -> (the TPU kernel it replaces, its source in the port)
KERNELS = {
    "factor_se": (f"{_PALLAS}:404", "factor_se.cu"),
    "fwd_se": (f"{_PALLAS}:748", "fwd_se.cu"),
    "bwd_matvec_se": (f"{_PALLAS}:663", "bwd_matvec_se.cu"),
    "bwd_se": (f"{_PALLAS}:524", "bwd_se.cu"),
    "factor_dense": (f"{_PALLAS}:172", "factor_dense.cu"),
    "fwd_dense": (f"{_PALLAS}:262", "solve_dense.cu"),
    "bwd_dense": (f"{_PALLAS}:262", "solve_dense.cu"),
    "stream_add_one": ("tools/kernel_bench.py:236", "probes.cu"),
    "fma_probe": ("tools/kernel_bench.py:264 (XLA-fused, no pallas_call)",
                  "probes.cu"),
}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, runs=25):
    """Median time of ``fn()`` in ms: CUDA events around each run on the
    card (after two warm-up runs), the host clock on the CPU."""
    import torch

    for _ in range(2):
        fn()
    _sync(device)
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        else:
            s = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - s))
    return statistics.median(times)


def synthetic_system(B, S, nw, nc, nnz, seed=0):
    """Well-conditioned random quasidefinite block-tridiagonal system,
    batch-major numpy f64: K [B, S, nz, nz], ev [B, S-1, nnz], reg [B, nz],
    r [B, S, nz]."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, S, nw, nw))
    A = M @ np.swapaxes(M, -1, -2) / nw + 2.0 * np.eye(nw)
    Q = rng.standard_normal((B, S, nc, nc))
    D = -(Q @ np.swapaxes(Q, -1, -2) / nc + np.eye(nc))
    J = rng.standard_normal((B, S, nc, nw))
    K = np.concatenate([np.concatenate([A, np.swapaxes(J, -1, -2)], -1),
                        np.concatenate([J, D], -1)], -2)
    ev = 0.3 * rng.standard_normal((B, S - 1, nnz))
    reg = np.tile(np.concatenate([np.full(nw, 1e-4), np.full(nc, -1e-4)]),
                  (B, 1))
    r = rng.standard_normal((B, S, nw + nc))
    return K, ev, reg, r


def synthetic_dense_e(B, S, nz, seed=1):
    """A genuinely dense coupling block per stage, 0.3 N(0, 1) / sqrt(nz),
    batch-major numpy f64 [B, S-1, nz, nz]."""
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal((B, S - 1, nz, nz)) / np.sqrt(nz)


def compare_kernels(bk, pat, K, ev, reg, r, device, timing):
    """Run each kernel and its plain version on the same inputs on
    ``device``; returns {name: {errors..., ms, plain_ms}}.  Each kernel's
    inputs come from the kernel before it."""
    import torch

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).contiguous()

    K, ev, reg, r = dev(K), dev(ev), dev(reg), dev(r)
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    Sinv_p, Wc_p = bk.factor_se_plain(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    y_p = bk.fwd_se_plain(Sinv, ev, r, pat)
    p, Ap = bk.bwd_matvec_se(Wc, y, K, ev, pat)
    p_p, Ap_p = bk.bwd_matvec_se_plain(Wc, y, K, ev, pat)
    q = bk.bwd_se(Wc, y, pat)
    q_p = bk.bwd_se_plain(Wc, y, pat)
    _sync(device)
    out = {
        "factor_se": {"Sinv": err(Sinv, Sinv_p), "Wc": err(Wc, Wc_p)},
        "fwd_se": {"y": err(y, y_p)},
        "bwd_matvec_se": {"p": err(p, p_p), "Ap": err(Ap, Ap_p)},
        "bwd_se": {"p": err(q, q_p)},
    }
    if timing:
        calls = {
            "factor_se": (lambda: bk.factor_se(K, ev, reg, pat),
                          lambda: bk.factor_se_plain(K, ev, reg, pat)),
            "fwd_se": (lambda: bk.fwd_se(Sinv, ev, r, pat),
                       lambda: bk.fwd_se_plain(Sinv, ev, r, pat)),
            "bwd_matvec_se": (
                lambda: bk.bwd_matvec_se(Wc, y, K, ev, pat),
                lambda: bk.bwd_matvec_se_plain(Wc, y, K, ev, pat)),
            "bwd_se": (lambda: bk.bwd_se(Wc, y, pat),
                       lambda: bk.bwd_se_plain(Wc, y, pat)),
        }
        add_times(out, calls, device)
    return out


def err(got, want):
    """(max abs error, max abs error / max |want|, got all finite)."""
    import torch

    a = float((got - want).abs().max())
    return a, a / max(float(want.abs().max()), 1e-30), \
        bool(torch.isfinite(got).all())


def device_text(d):
    """The device time of one kernel's timing, as its lines print it."""
    if d["device_ms"] is None:
        return "device time not measured (the profiler recorded no CUDA " \
               "kernels)"
    return (f"device {d['device_ms']:.4f} ms ({d['device_launches']:g} "
            f"launches a call)")


def add_times(out, calls, device):
    """Median CUDA-event times of each kernel and its plain version, and
    the kernel's device time per call."""
    from obca_torch.tools.kernel_bench import device_ms

    for name, (kern, plain) in calls.items():
        out[name]["ms"] = time_ms(kern, device)
        out[name]["device_ms"], out[name]["device_launches"] = \
            device_ms(kern)
        out[name]["plain_ms"] = time_ms(plain, device, runs=20)


def compare_dense_kernels(bd, K, E, reg, r, device, timing):
    """The dense-coupling kernels against their plain versions on the
    same inputs (reg added to K's diagonal first, as
    ``kkt.make_kkt_solver`` does); each kernel's inputs come from the
    kernel before it."""
    import torch

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).contiguous()

    K, E, reg, r = dev(K), dev(E), dev(reg), dev(r)
    K = (K + torch.diag_embed(reg)[:, None]).contiguous()
    Sinv, W = bd.factor_dense(K, E)
    Sinv_p, W_p = bd.factor_dense_plain(K, E)
    y = bd.fwd_dense(Sinv, E, r)
    y_p = bd.fwd_dense_plain(Sinv, E, r)
    x = bd.bwd_dense(W, y)
    x_p = bd.bwd_dense_plain(W, y)
    _sync(device)
    out = {
        "factor_dense": {"Sinv": err(Sinv, Sinv_p), "W": err(W, W_p)},
        "fwd_dense": {"y": err(y, y_p)},
        "bwd_dense": {"x": err(x, x_p)},
    }
    if timing:
        add_times(out, {
            "factor_dense": (lambda: bd.factor_dense(K, E),
                             lambda: bd.factor_dense_plain(K, E)),
            "fwd_dense": (lambda: bd.fwd_dense(Sinv, E, r),
                          lambda: bd.fwd_dense_plain(Sinv, E, r)),
            "bwd_dense": (lambda: bd.bwd_dense(W, y),
                          lambda: bd.bwd_dense_plain(W, y)),
        }, device)
    return out


def compare_probes(device, shape):
    """The kernel bench's probe kernels against their plain versions on
    the card, on one float32 array of ``shape`` from a seed: the stream
    kernel there and over an odd n from a 4-byte offset (the scalar
    route), the FMA probe there; with the times of each, and PyTorch's
    ``x + 1`` as the stream kernel's library time."""
    import torch
    from obca_torch.solver.kernels import probes

    x = torch.randn(shape, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    buf = torch.randn(100_003, device=device,
                      generator=torch.Generator(device).manual_seed(1))
    odd = buf[1:]
    if odd.numel() % 4 == 0 or odd.data_ptr() % 16 == 0:
        raise RuntimeError("the odd probe input is not odd and unaligned")
    fma, fma_plain = probes.fma_probe(x), probes.fma_probe_plain(x)
    out = {
        "stream_add_one": {
            "x": err(probes.stream_add_one(x), probes.stream_add_one_plain(x)),
            "odd": err(probes.stream_add_one(odd),
                       probes.stream_add_one_plain(odd))},
        "fma_probe": {"x": err(fma, fma_plain),
                      "ulps": probes.max_ulps(fma, fma_plain)},
    }
    add_times(out, {
        "stream_add_one": (lambda: probes.stream_add_one(x),
                           lambda: probes.stream_add_one_plain(x)),
        "fma_probe": (lambda: probes.fma_probe(x),
                      lambda: probes.fma_probe_plain(x)),
    }, device)
    # The plain version is PyTorch's x + 1, the library call itself.
    out["stream_add_one"]["library_ms"] = out["stream_add_one"]["plain_ms"]
    return out


def check_probes(res):
    """Print the probes' errors; raise unless the stream kernel is x + 1
    exactly and the FMA probe is within PROBE_ULPS of its plain version
    at every element."""
    print_errors("probe", res)
    for what, v in res["stream_add_one"].items():
        if isinstance(v, tuple) and not (v[0] == 0.0 and v[2]):
            raise RuntimeError(f"stream_add_one.{what} is not x + 1: "
                               f"max abs err {v[0]:.3e}")
    fma = res["fma_probe"]
    print(f"probe fma_probe.x: max_ulps {fma['ulps']:g}")
    if not fma["x"][2] or not fma["ulps"] <= PROBE_ULPS:
        raise RuntimeError(f"fma_probe disagrees with its plain version: "
                           f"{fma['ulps']:g} units in the last place")


def print_errors(label, res):
    for name, d in res.items():
        for what, v in d.items():
            if isinstance(v, tuple):
                print(f"{label} {name}.{what}: max_abs_err {v[0]:.3e} "
                      f"max_rel_err {v[1]:.3e} finite {v[2]}")


def main_path_batch(device, B=B_MAIN, N=N_MAIN, Ts=TS_MAIN, dtype=None):
    """bench.py's batch: B start-pose shifts of the canonical reverse
    parking scenario in ``dtype`` (default float32; float64 is
    ``BENCH_DTYPE=mixed``).  The shifts are float32 draws, as there."""
    import torch
    from obca_torch import reverse_parking_spec
    from obca_torch import spec as tspec

    dtype = dtype or torch.float32
    base = reverse_parking_spec(N=N, Ts=Ts, dtype=dtype, device=device)
    shifts = np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(B, 2)).astype(np.float32)
    specs = tspec.stack([
        dataclasses.replace(base, x0=base.x0 + torch.tensor(
            [dx, dy, 0.0, 0.0], dtype=dtype, device=device))
        for dx, dy in shifts])
    return base, specs


def run_main_path(base, specs, cfg):
    """plan_field -> lattice_warm_start -> solve_batch_rescued; returns
    the result and the seconds of each stage."""
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric, lattice

    dev = base.x0.device
    t = [time.perf_counter()]
    lcfg = lattice.LatticeConfig.for_spec(base)
    field = lattice.plan_field(base, lcfg)
    _sync(dev)
    t.append(time.perf_counter())
    W0 = geometric.lattice_warm_start(specs, dtype=base.x0.dtype, cfg=lcfg,
                                      field=field)
    _sync(dev)
    t.append(time.perf_counter())
    res = ipm.solve_batch_rescued(specs, cfg, W0, rescue_mu=1e-5)
    _sync(dev)
    t.append(time.perf_counter())
    secs = {"plan_field_s": t[1] - t[0], "warm_start_s": t[2] - t[1],
            "solve_s": t[3] - t[2], "wall_s": t[3] - t[0]}
    return res, secs


class FirstIterationCapture:
    """Records the (K, ev, reg) of the second factorization (the first
    IPM iteration; the first one is the dual least-squares start) and the
    right-hand side of the forward substitution that follows it, while
    passing every call through to the real wrapper.  With ``keep_last``
    it also records the run's last factorization and the right-hand side
    after it (``last_system``, ``last_rhs``); the copies are made on the
    card and add no launch of the port's kernels.  The first IPM
    iteration is a solve's eager turn on either path; a replayed loop
    turn calls the forward substitution inside its CUDA graph, not from
    Python, so with ``keep_last`` the solve runs every turn eagerly (the
    same arithmetic, bit for bit)."""

    def __init__(self, bk, keep_last=False):
        self.bk = bk
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

        self.bk.factor_se, self.bk.fwd_se = factor, fwd
        if self.keep_last:
            from obca_torch.solver import ipm

            self._use_graphs = ipm._use_graphs
            ipm._use_graphs = lambda device: False
        return self

    def __exit__(self, *exc):
        self.bk.factor_se, self.bk.fwd_se = self._factor, self._fwd
        if self.keep_last:
            from obca_torch.solver import ipm

            ipm._use_graphs = self._use_graphs


def stage_inverse_accuracy(bk, pat, nw, K, ev, reg):
    """How exactly the factor inverts the real system in float32.
    Returns the kernel factor's max relative error against a float64
    factor of the same system, and, on the stage-0 block alone, the
    float64 condition number (median over lanes) and the pivot-free,
    primal-first inverse of the TPU kernel (``blocktri.qd_inv``) in
    float32: its non-finite lanes and its max relative error on the
    others."""
    import torch
    from obca_torch.solver import blocktri

    def rel(got, want):
        dims = tuple(range(1, want.dim()))
        return ((got.double() - want).abs().amax(dims)
                / want.abs().amax(dims))

    Sinv, _ = bk.factor_se(K, ev, reg, pat)
    Sinv64, _ = bk.factor_se_plain(K.double(), ev.double(), reg.double(),
                                   pat)
    A0 = K[:, 0].double() + torch.diag_embed(reg.double())
    inv0 = torch.linalg.inv(A0)
    qd = blocktri.qd_inv(A0.float(), nw)
    fin = torch.isfinite(qd.reshape(qd.shape[0], -1)).all(1)
    return {
        "kernel_factor_rel_err_max": float(rel(Sinv, Sinv64).max()),
        "stage0_cond_median": float(torch.linalg.cond(A0).median()),
        "stage0_kernel_rel_err_max": float(rel(Sinv[:, 0], inv0).max()),
        "stage0_primal_first_nonfinite_lanes": int((~fin).sum()),
        "stage0_primal_first_rel_err_max": (
            float(rel(qd[fin], inv0[fin]).max()) if fin.any() else None),
    }


def device_profile(fn):
    """Run ``fn`` under torch.profiler: (wall s, device busy s, the
    eight CUDA kernels with the most device time as (name, ms, calls),
    and {port kernel: (ms, calls)} for each of :data:`KERNELS` that ran,
    found by its CUDA function's name, ``<kernel>_kernel``).  Busy time
    is the sum of kernel times (one stream, no overlap).  Only the
    device is traced: with the host's operator events traced too, the
    f32 main path's phase took 121.7 s on an H100 for about 30 s of
    runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    ours = {}
    for name in KERNELS:
        hits = [e for e in kern if f"{name}_kernel" in e.key]
        if hits:
            ours[name] = (sum(e.self_device_time_total for e in hits) / 1e3,
                          sum(e.count for e in hits))
    return wall, busy, [(e.key[:60], e.self_device_time_total / 1e3,
                         e.count) for e in top], ours


def parity_gap(device, golden, cfg, signed=True, family="reverse"):
    """max |U - U_gold| of ``cfg``'s solve of one golden instance from its
    warm start, in the configuration's iterate dtype, with the solve's
    status and iterations and |tau - tau_gold|.  A free-time golden
    (``fix_time`` 0) is solved by ``ipm.solve_free_time`` (its
    iterations: the free-time phase's)."""
    import torch
    import obca_torch as ot
    from obca_torch.solver import ipm

    gold = np.load(os.path.join(ROOT, "oracle", "goldens",
                                f"{golden}.npz"))
    fix_time = bool(gold["fix_time"])
    make = {"reverse": ot.reverse_parking_spec,
            "parallel": ot.parallel_parking_spec}[family]
    spec = make(N=int(gold["N"]), Ts=float(gold["Ts"]), signed=signed,
                fix_time=fix_time, dtype=cfg.dtype, device=device)
    W0 = torch.as_tensor(gold["W0"], dtype=cfg.dtype, device=device)
    solve = ipm.solve_single if fix_time else ipm.solve_free_time
    res = solve(spec, cfg, W0)
    gap = float(np.abs(res.U.double().cpu().numpy() - gold["U"]).max())
    return (gap, int(res.status), int(res.iters),
            abs(float(res.tau) - float(gold["tau"])))


def measure_main_path(bk, base, specs, cfg):
    """One warm-up run (which captures the first IPM iteration's
    system), the counted run (every launch count set to 0 just before it
    and read just after), then two more timed runs.  Returns (summary,
    the capture)."""
    import torch
    from obca_torch.solver import ipm

    with FirstIterationCapture(bk) as cap:
        _, warm_secs = run_main_path(base, specs, cfg)
    bk.reset_launches()
    res, secs = run_main_path(base, specs, cfg)
    launches = dict(bk.launches)
    walls = [secs["wall_s"]] + [run_main_path(base, specs, cfg)[1]["wall_s"]
                                for _ in range(2)]
    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    n_conv = int((status == ipm.STATUS_CONVERGED).sum())
    B, N = specs.x0.shape[0], base.N
    if not torch.isfinite(res.U).all():
        raise RuntimeError("main path returned non-finite controls")
    if res.U.shape != (B, N, 2):
        raise RuntimeError(f"main path U has shape {tuple(res.U.shape)}")
    main = {
        "B": B, "N": N, "dtype": str(base.x0.dtype).replace("torch.", ""),
        "converged": n_conv,
        "status_counts": {int(k): int(v) for k, v in
                          zip(*np.unique(status, return_counts=True))},
        "iters_median": float(np.median(iters)),
        "iters_max": int(iters.max()),
        "warmup_wall_s": warm_secs["wall_s"],
        **{k: round(v, 4) for k, v in secs.items()},
        "solves_per_s": B / secs["wall_s"],
        "converged_solves_per_s": n_conv / secs["wall_s"],
        "wall_s_runs": walls,
        "converged_solves_per_s_median": n_conv / statistics.median(walls),
        "launches": launches,
    }
    return main, cap


def print_profile(label, run, wall_median):
    """Profile ``run`` and print its device busy share of
    ``wall_median`` (the unprofiled wall of the same work), the top
    kernels and the port's kernels."""
    p_wall, p_busy, p_top, p_ours = device_profile(run)
    if p_busy > 0:
        print(f"profiled {label}: wall {p_wall:.3f} s, device busy "
              f"{p_busy:.3f} s ({100 * p_busy / wall_median:.1f}% of the "
              f"unprofiled median wall {wall_median:.3f} s)")
        for name, ms, calls in p_top:
            print(f"  device {ms:9.2f} ms  {calls:6d} calls  {name}")
        for name, (ms, calls) in p_ours.items():
            print(f"  kernel {name}: device {ms:.2f} ms over {calls} "
                  f"calls, {ms / calls:.4f} ms each")
    else:
        print(f"profiled {label}: device time not measured (the "
              "profiler recorded no CUDA kernels)")


def dense_vs_structured(bk, nw, rows, cols, K, ev, reg, rhs):
    """The dense-coupling solver against the structured one on the same
    float32 system, E built from ev at (rows, cols).  Returns the max
    relative difference of d, both solves' max linear residuals and
    whether d is finite."""
    import torch
    from obca_torch.solver import kkt

    B, S, nz, _ = K.shape
    E = torch.zeros((B, S - 1, nz, nz), dtype=K.dtype, device=K.device)
    E[:, :, torch.as_tensor(rows, device=K.device),
      torch.as_tensor(cols, device=K.device)] = ev
    f32 = torch.float32
    d_dense, lin_dense = kkt.make_kkt_solver(nw, 4, f32, f32)(K, E, reg,
                                                              rhs)
    d_se, lin_se = kkt.make_kkt_solver_se(nw, 4, f32, f32, rows, cols)(
        K, ev, reg, rhs)
    _sync(K.device)
    return {
        "d_rel_diff": float((d_dense - d_se).abs().max()
                            / d_se.abs().max()),
        "lin_res_dense_max": float(lin_dense.max()),
        "lin_res_structured_max": float(lin_se.max()),
        "finite": bool(torch.isfinite(d_dense).all()),
    }


def wide_pattern():
    """The stage layout and coupling pattern of the topology-varied
    families (4 obstacles of 5 faces: nz = 72)."""
    from obca_torch import nlp, reverse_parking_spec
    from obca_torch.solver.kernels import blocktri_se as bk

    L = nlp.layout_of(reverse_parking_spec(N=N_MAIN, Ts=TS_MAIN, max_obs=4,
                                           max_faces=5, device="cpu"))
    rows, cols = nlp.coupling_structure(L)
    return L, rows, cols, bk.CouplingPattern.of(rows, cols)


def interchange_system(K, reg, kind, seed=2):
    """Stage blocks that need row interchanges, as the card tests build
    them: every block's rows permuted ("permuted"), or its regularized
    leading diagonal entry set to 1e-8 ("tiny_lead")."""
    K = K.copy()
    if kind == "tiny_lead":
        K[:, :, 0, 0] = 1e-8 - reg[:, None, 0]
        return K
    rng = np.random.default_rng(seed)
    perm = np.argsort(rng.random(K.shape[:3]), axis=-1)
    return np.take_along_axis(K, perm[..., None], axis=2)


def compare_wide_kernels(bk, bd, device, B=B_MAIN, S=N_MAIN + 1,
                         timing=True):
    """Phase 3w: the seven solver kernels at nz = 72 (their wide
    instantiations) against their plain versions, on the synthetic
    system with the families' coupling pattern and on its two
    interchange variants.  Returns ({name: errors and times}, {kind:
    {name: errors}}, (nz, nnz, C))."""
    L, _, _, pat = wide_pattern()
    nnz, C = len(pat.rows), len(pat.ucols)
    K, ev, reg, r = synthetic_system(B, S, L.nw, L.nc, nnz, seed=3)
    E = synthetic_dense_e(B, S, L.nz, seed=4)
    res = compare_kernels(bk, pat, K, ev, reg, r, device, timing)
    res.update(compare_dense_kernels(bd, K, E, reg, r, device, timing))
    inter = {}
    for kind in ("permuted", "tiny_lead"):
        Ki = interchange_system(K, reg, kind)
        inter[kind] = compare_kernels(bk, pat, Ki, ev, reg, r, device, False)
        inter[kind].update(compare_dense_kernels(bd, Ki, E, reg, r, device,
                                                 False))
    return res, inter, (L.nz, nnz, C)


def random_family_batch(device, family, B, n_layouts, N=N_MAIN, Ts=TS_MAIN,
                        dtype=None, seed=0):
    """``bench/run_sweep.py``'s shard: a randomized batch of ``family``
    ("reverse": topology-varied; "parallel": its default, topology-
    varied too) and the static lattice grid of the family's base spec
    padded to 4 obstacles of 5 faces."""
    import torch
    import obca_torch as ot
    from obca_torch.warmstart import lattice

    dtype = dtype or torch.float32
    if family == "reverse":
        specs, layouts, _ = ot.randomized_reverse_parking_specs(
            B, n_layouts=n_layouts, seed=seed, N=N, Ts=Ts,
            vary_topology=True, dtype=dtype, device=device)
        base = ot.reverse_parking_spec(N=N, Ts=Ts, max_obs=4, max_faces=5,
                                       dtype=dtype, device=device)
    else:
        specs, layouts, _ = ot.randomized_parallel_parking_specs(
            B, n_layouts=n_layouts, seed=seed, N=N, Ts=Ts, dtype=dtype,
            device=device)
        base = ot.parallel_parking_spec(N=N, Ts=Ts, max_obs=4, max_faces=5,
                                        dtype=dtype, device=device)
    return specs, layouts, lattice.LatticeConfig.for_spec(base)


def run_grouped(specs, layouts, lcfg, cfg):
    """One plan field per layout -> grouped lattice warm start ->
    solve_batch_rescued (rescue mu 1e-5); the result and the seconds of
    each stage."""
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric

    dev = specs.x0.device
    t = [time.perf_counter()]
    fields = geometric.layout_fields(layouts, lcfg)
    _sync(dev)
    t.append(time.perf_counter())
    W0 = geometric.grouped_lattice_warm_start(specs, layouts, lcfg,
                                              dtype=cfg.dtype, fields=fields)
    _sync(dev)
    t.append(time.perf_counter())
    res = ipm.solve_batch_rescued(specs, cfg, W0, rescue_mu=1e-5)
    _sync(dev)
    t.append(time.perf_counter())
    return res, {"plan_fields_s": t[1] - t[0], "warm_start_s": t[2] - t[1],
                 "solve_s": t[3] - t[2], "wall_s": t[3] - t[0]}


def lane_checks(specs, res):
    """Each converged lane against its own geometry and goal: the
    smallest clearance over its stages and real obstacles (the SAT gap,
    which never exceeds the distance, and the exact polygon distance
    wherever the gap is below d_min - LANE_TOL) minus d_min, and the
    largest |x_N - xF|.  Returns (lanes checked, lanes whose clearance
    falls below d_min - LANE_TOL, lanes off their goal by more than
    LANE_TOL, worst clearance margin, worst goal error)."""
    from obca_torch import geometry
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm

    ok = (res.status == ipm.STATUS_CONVERGED).cpu().numpy()
    X = res.X.double()
    n_clear = n_goal = 0
    worst_clear, worst_goal = float("inf"), 0.0
    for i in np.flatnonzero(ok):
        sp = tspec.cast_floats(tspec.take(specs, int(i)), X.dtype)
        x = X[i].to(sp.x0.device)
        gap = geometry.ego_clearance_flat(x[:, 0], x[:, 1], x[:, 2],
                                          sp.ego_g, sp.obstacles)
        margin = clearance_margin(sp, x, gap)
        goal = float((x[-1] - sp.xF).abs().max())
        worst_clear = min(worst_clear, margin)
        worst_goal = max(worst_goal, goal)
        n_clear += margin < -LANE_TOL
        n_goal += goal > LANE_TOL
    return int(ok.sum()), n_clear, n_goal, worst_clear, worst_goal


def clearance_margin(sp, x, gap):
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


def summarize(specs, res, secs, walls=None):
    """Converged count, iterations, the stage seconds and rates of a
    randomized-batch run, with its lane checks."""
    from obca_torch.solver import ipm

    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    n_conv = int((status == ipm.STATUS_CONVERGED).sum())
    checked, n_clear, n_goal, worst_clear, worst_goal = lane_checks(specs,
                                                                    res)
    out = {
        "B": int(specs.x0.shape[0]), "N": specs.N, "converged": n_conv,
        "status_counts": {int(k): int(v) for k, v in
                          zip(*np.unique(status, return_counts=True))},
        "iters_median": float(np.median(iters)),
        "iters_max": int(iters.max()),
        **secs,
        "converged_solves_per_s": n_conv / secs["wall_s"],
        "lanes_checked": checked, "lanes_too_close": n_clear,
        "lanes_off_goal": n_goal, "worst_clearance_margin": worst_clear,
        "worst_goal_err": worst_goal,
    }
    if walls:
        out["wall_s_runs"] = walls
        out["wall_s_median"] = statistics.median(walls)
        out["wall_s_spread"] = max(walls) - min(walls)
        out["converged_solves_per_s_median"] = (
            n_conv / statistics.median(walls))
    return out


def measure_random_family(bk, specs, layouts, lcfg, cfg, repeats):
    """One warm-up run, the counted run (launch counts set to 0 just
    before it and read just after), then repeats - 1 more timed runs.
    Returns the summary of the counted run."""
    run_grouped(specs, layouts, lcfg, cfg)
    bk.reset_launches()
    res, secs = run_grouped(specs, layouts, lcfg, cfg)
    launches = dict(bk.launches)
    walls = [secs["wall_s"]] + [
        run_grouped(specs, layouts, lcfg, cfg)[1]["wall_s"]
        for _ in range(repeats - 1)]
    out = summarize(specs, res, secs, walls)
    out["launches"] = launches
    return out


def check_random_family(label, out, min_converged):
    if out["converged"] < min_converged:
        raise RuntimeError(f"{label}: {out['converged']} lanes converged, "
                           f"fewer than {min_converged}")
    if out["lanes_too_close"] or out["lanes_off_goal"]:
        raise RuntimeError(f"{label}: converged lanes fail their checks: "
                           f"{out['lanes_too_close']} too close to an "
                           f"obstacle, {out['lanes_off_goal']} off the "
                           f"goal")


def mpc_fleet_batch(device, B=B_MPC, N=N_MAIN, spread=MPC_SPREAD, dtype=None,
                    seed=0):
    """``bench/run_mpc.py``'s fleet: B starts of
    ``reverse_parking_spec(N, Ts=24/N)`` in ``dtype`` (default float32),
    each start's x, y shifted by float32 draws of
    ``np.random.default_rng(seed).uniform(-spread, spread, (B, 2))``
    (``bench/_common.py``'s ``scenario_batch``)."""
    import torch
    from obca_torch import reverse_parking_spec
    from obca_torch import spec as tspec

    dtype = dtype or torch.float32
    base = reverse_parking_spec(N=N, Ts=24.0 / N, dtype=dtype, device=device)
    x0 = np.tile(base.x0.cpu().numpy(), (B, 1))
    x0[:, :2] += np.random.default_rng(seed).uniform(
        -spread, spread, size=(B, 2)).astype(x0.dtype)
    specs = dataclasses.replace(tspec.stack([base] * B),
                                x0=torch.as_tensor(x0, device=device))
    return base, specs


def run_mpc_fleet(base, specs, cfg, steps):
    """One plan field for the fleet, a per-lane lattice warm start, then
    ``mpc.run_fleet`` (rescued initial plans, then ``steps`` control
    periods; ``bench/run_mpc.py``'s re-solve knobs).  Returns the result
    and the wall seconds of the whole pipeline."""
    from obca_torch import mpc
    from obca_torch.warmstart import geometric, lattice

    t0 = time.perf_counter()
    lcfg = lattice.LatticeConfig.for_spec(base)
    field = lattice.plan_field(base, lcfg)
    W0 = geometric.lattice_warm_start(specs, dtype=cfg.dtype, cfg=lcfg,
                                      field=field)
    res = mpc.run_fleet(specs, cfg, steps, W0, resolve_mu=RESOLVE_MU,
                        resolve_max_iter=RESOLVE_ITERS,
                        resolve_tol=RESOLVE_TOL)
    _sync(base.x0.device)
    return res, time.perf_counter() - t0


def summarize_mpc(specs, res, wall):
    """``bench/run_mpc.py``'s fleet numbers, the periods whose batched
    re-solve reached the cap (its slowest lane ran RESOLVE_ITERS
    iterations), the failed re-solves of each period, and the
    closed-loop checks: every state finite, each
    rollout's worst clearance (``geometry.ego_clearance_exact`` against
    its own obstacles, see :func:`clearance_margin`) and whether it ended
    nearer its goal than it started."""
    import torch
    from obca_torch import geometry
    from obca_torch import spec as tspec

    B, steps = res.status.shape
    status0 = res.status0.cpu().numpy()
    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    states = res.states.double()
    margins = []
    for i in range(B):
        sp = tspec.cast_floats(tspec.take(specs, i), torch.float64)
        x = states[i].to(sp.x0.device)
        gap = geometry.ego_clearance_exact(x, sp.ego_g, sp.obstacles)
        margins.append(clearance_margin(sp, x, gap.amin(-1)))
    goal = specs.xF[:, :2].double()
    d_start = (states[:, 0, :2] - goal).norm(dim=-1)
    d_end = (states[:, -1, :2] - goal).norm(dim=-1)
    return {
        "B": B, "N": specs.N, "steps": steps,
        "dtype": str(specs.x0.dtype).replace("torch.", ""),
        "wall_s": wall, "ms_per_mpc_step_fleet": wall / steps * 1e3,
        "achieved_hz_fleet": steps / wall,
        "solves_per_s": B * steps / wall,
        "initial_plan_convergence_rate": float((status0 == 0).mean()),
        "step_convergence_rate": float((status == 0).mean()),
        "resolve_iters_p50": float(np.median(iters)),
        "resolve_iters_max": int(iters.max()),
        "periods_at_cap": int((iters.max(axis=0) >= RESOLVE_ITERS).sum()),
        "failed_per_period": (status != 0).sum(axis=0).tolist(),
        "states_finite": bool(torch.isfinite(states).all()),
        "worst_clearance_margin": min(margins),
        "rollouts_too_close": int(sum(m < -LANE_TOL for m in margins)),
        "rollouts_not_nearer_goal": int((d_end >= d_start).sum()),
    }


def check_mpc(out):
    """Phase 9's gates."""
    if out["initial_plan_convergence_rate"] < 1.0:
        raise RuntimeError(f"mpc: initial plans converged at rate "
                           f"{out['initial_plan_convergence_rate']}, not 1")
    if not out["step_convergence_rate"] >= MPC_MIN_STEP_CONV:
        raise RuntimeError(f"mpc: step convergence "
                           f"{out['step_convergence_rate']} < "
                           f"{MPC_MIN_STEP_CONV}")
    if not out["states_finite"] or out["rollouts_too_close"] \
            or out["rollouts_not_nearer_goal"]:
        raise RuntimeError(f"mpc: closed-loop checks failed: {out}")


def measure_mpc_single(bk, base, specs, cfg, steps=MPC_STEPS,
                       steps_short=MPC_STEPS_SHORT):
    """Phase 9s: rollout 0 alone (B = 1) through ``run_mpc_fleet``: a
    2-period warm-up (which captures its last factorization, one of
    period 2's re-solve), the counted run of ``steps`` periods, then one
    of ``steps_short``; the steady per-period time is the slope between
    the two walls (``bench/run_mpc.py``'s method).  Returns (summary,
    the capture)."""
    from obca_torch import spec as tspec

    one = tspec.take(specs, slice(0, 1))
    with FirstIterationCapture(bk, keep_last=True) as cap:
        run_mpc_fleet(base, one, cfg, 2)
    bk.reset_launches()
    res, wall = run_mpc_fleet(base, one, cfg, steps)
    launches = dict(bk.launches)
    _, wall_short = run_mpc_fleet(base, one, cfg, steps_short)
    steady = (wall - wall_short) / (steps - steps_short)
    return {
        "steps": steps, "wall_s": wall, "steps_short": steps_short,
        "wall_short_s": wall_short,
        "ms_per_mpc_step_single": wall / steps * 1e3,
        "achieved_hz_single": steps / wall,
        "ms_per_mpc_step_single_steady": steady * 1e3,
        "achieved_hz_single_steady": 1.0 / steady,
        "status0": int(res.status0[0]),
        "step_convergence_rate_single":
            float((res.status == 0).float().mean()),
        "resolve_iters_p50": float(res.iters.float().median()),
        "resolve_iters_max": int(res.iters.max()),
        "launches": launches,
    }, cap


def check_mpc_run(bk, base, specs, cfg, steps=MPC_RUN_STEPS):
    """Phase 9s's single-vehicle entry point: rollout 0's ``mpc.run``
    from its ``ipm.solve_single`` plan (``res0``) for ``steps`` periods,
    its launches counted, then ``mpc.run_fleet`` at B = 1 from the same
    warm start.  Returns the summary; raises unless the plan and every
    period ended with the fleet's status and every closed-loop state lies
    within MPC_RUN_TOL of the fleet's."""
    import torch
    from obca_torch import mpc
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric, lattice

    one = tspec.take(specs, slice(0, 1))
    spec0 = tspec.take(specs, 0)
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(one, dtype=cfg.dtype, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    knobs = dict(resolve_mu=RESOLVE_MU, resolve_max_iter=RESOLVE_ITERS,
                 resolve_tol=RESOLVE_TOL)
    bk.reset_launches()
    t0 = time.perf_counter()
    res0 = ipm.solve_single(spec0, cfg, W0[0])
    res = mpc.run(spec0, cfg, steps, W0[0], res0=res0, **knobs)
    _sync(base.x0.device)
    wall = time.perf_counter() - t0
    launches = dict(bk.launches)
    fleet = mpc.run_fleet(one, cfg, steps, W0, **knobs)
    gap = float((res.states - fleet.states[0]).abs().max())
    out = {
        "steps": steps, "wall_s": wall, "status0": int(res.status0),
        "iters0": int(res.iters0), "status": res.status.tolist(),
        "iters": res.iters.tolist(),
        "fleet_status0": int(fleet.status0[0]),
        "fleet_iters0": int(fleet.iters0[0]),
        "fleet_status": fleet.status[0].tolist(),
        "fleet_iters": fleet.iters[0].tolist(),
        "max_state_gap": gap, "launches": launches,
    }
    if (out["status0"] != out["fleet_status0"]
            or out["status"] != out["fleet_status"]
            or not gap < MPC_RUN_TOL or not torch.isfinite(res.states).all()):
        raise RuntimeError(f"mpc.run disagrees with run_fleet at B = 1: "
                           f"{out}")
    return out


def compare_captured(bk, label, system, rhs, device, route):
    """The kernels against their plain versions on a captured system
    (``compare_kernels``): every output printed, and the kernels of
    ``route`` held to SYNTH_TOL."""
    K, ev, reg, pat = system
    res = compare_kernels(bk, pat, K, ev, reg, rhs, device, timing=False)
    label = f"{label} (B={K.shape[0]}, S={K.shape[1]}, nz={K.shape[2]})"
    print_errors(label, res)
    check_errors(label, {name: res[name] for name in route})


def nav_batch(device, B=B_NAV, N=60, spread=NAV_SPREAD, seed=0):
    """Phase 10's batch: B lanes of ``nav.nav_spec()`` (N=60, Ts=0.25,
    4 obstacles of 4 faces: nz = 44) in float64 on the grazing layout of
    ``tests/test_nav.py``, lane b's start y shifted by
    ``np.random.default_rng(seed).uniform(-spread, spread, B)[b]``."""
    import torch
    from obca_torch import nav
    from obca_torch import spec as tspec

    base = nav.nav_spec(N=N, vertex_lists=NAV_VERTS, device=device)
    x0 = np.tile(base.x0.cpu().numpy(), (B, 1))
    x0[:, 1] += np.random.default_rng(seed).uniform(-spread, spread, B)
    specs = dataclasses.replace(tspec.stack([base] * B),
                                x0=torch.as_tensor(x0, device=device))
    return base, specs


def summarize_nav(specs, res, wall):
    """Converged count and the checks of each converged lane: its
    boundary conditions (max |x_0 - x0|, |x_N - xF|) and the geometric
    audit of ``test_nav_end_to_end_collision_free`` (every stage point's
    largest face value max_v(A_m p - b_m) over every real obstacle,
    minus d_min)."""
    import torch
    from obca_torch.solver import ipm

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
    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    n_conv = int(ok.sum())
    return {
        "B": int(specs.x0.shape[0]), "N": specs.N, "converged": n_conv,
        "status_counts": {int(k): int(v) for k, v in
                          zip(*np.unique(status, return_counts=True))},
        "iters_median": float(np.median(iters)),
        "iters_max": int(iters.max()), "wall_s": wall,
        "converged_solves_per_s": n_conv / wall,
        "worst_bc_err": float(bc[ok].max()) if n_conv else None,
        "worst_clearance_margin": (float(margin[ok].min()) if n_conv
                                   else None),
        "lanes_bc_off": int((bc[ok] > NAV_BC_TOL).sum()),
        "lanes_too_close": int((margin[ok] < -NAV_CLEAR_TOL).sum()),
    }


def require_route(label, launches, used, unused):
    """Raise unless ``factor_se``, ``fwd_se`` and ``used`` launched and
    ``unused`` did not (the f32 route runs ``bwd_matvec_se``, the mixed
    route ``bwd_se``)."""
    if min(launches["factor_se"], launches["fwd_se"], launches[used]) <= 0 \
            or launches[unused] != 0:
        raise RuntimeError(f"{label}: the expected route did not run: "
                           f"launches {launches}")


def check_nav(out, status0):
    """Phase 10's gates."""
    from obca_torch.solver import ipm

    if out["lanes_bc_off"] or out["lanes_too_close"]:
        raise RuntimeError(f"nav: converged lanes fail their checks: {out}")
    if not out["eager_bitwise"]:
        raise RuntimeError("nav: the graph-replayed solve and the eager "
                           "one differ")
    least = NAV_JAX_CONVERGED - NAV_COUNT_SLACK
    if out["converged"] < least:
        raise RuntimeError(f"nav: {out['converged']} lanes converged, "
                           f"fewer than {least}")
    if status0 != ipm.STATUS_CONVERGED or \
            not out["lane0_cpu_gap"] <= NAV_PARITY_TOL:
        raise RuntimeError(f"nav: lane 0 (status {status0}) is "
                           f"{out['lane0_cpu_gap']:.3e} from its float64 "
                           f"CPU solve")


def same_result(a, b):
    """Whether two ``SolveResult``s are equal bit for bit, the dual
    state included."""
    import dataclasses

    import torch

    pairs = list(zip(a[:-1], b[:-1])) + [
        (getattr(a.duals, f.name), getattr(b.duals, f.name))
        for f in dataclasses.fields(a.duals)]
    return all(torch.equal(x, y) for x, y in pairs)


def nav_cpu_gap(specs, res):
    """Lane 0's controls against the port's float64 solve of the same
    spec on the CPU (``nav.solve`` under ``SolverConfig(max_iter=
    ITERS_NAV)``): (max |U - U_cpu|, the CPU solve's status and
    iterations)."""
    from obca_torch import SolverConfig, nav
    from obca_torch import spec as tspec

    spec0 = tspec.map_tensors(lambda t: t.cpu(), tspec.take(specs, 0))
    ref = nav.solve(spec0, SolverConfig(max_iter=ITERS_NAV))
    gap = float((res.U[0].double().cpu() - ref.U).abs().max())
    return gap, int(ref.status), int(ref.iters)


def free_port():
    """A free localhost TCP port for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def local_metrics(res):
    """``mesh.solve_sharded``'s metrics computed here from one result,
    with the mesh's arithmetic (float64 sums, the means divided after
    the sum): what one rank's all-reduce must give back."""
    import torch
    from obca_torch.solver import ipm

    B = float(res.status.shape[0])
    f64 = torch.float64
    return {
        "n_converged": int((res.status == ipm.STATUS_CONVERGED).sum()),
        "max_err": float(res.err.to(f64).max().to(res.err.dtype)),
        "mean_iters": float((res.iters.to(f64).sum() / B).float()),
        "mean_obj": float((res.obj.to(f64).sum() / B).to(res.obj.dtype)),
    }


def run_sharded(bk, specs, W0, cfg, backend="nccl"):
    """Phase 11: a one-rank process group on this card (``backend``; the
    CPU rehearsal passes "gloo"), its global mesh, ``solve_sharded``
    counted (every launch count set to 0 just before, read just after)
    and ``ipm.solve_batch`` on the same inputs beside it; the group is
    destroyed before the function returns.  Returns (summary, the
    sharded result)."""
    import torch
    from obca_torch.parallel import distributed
    from obca_torch.parallel import mesh as mesh_mod
    from obca_torch.solver import ipm

    dev = specs.x0.device
    distributed.initialize(f"localhost:{free_port()}", num_processes=1,
                           process_id=0, local_device_ids=[str(dev)],
                           backend=backend)
    try:
        mesh = distributed.global_scenario_mesh()
        bk.reset_launches()
        t0 = time.perf_counter()
        res, met = mesh_mod.solve_sharded(specs, cfg, mesh, W0)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(bk.launches)
        ref = ipm.solve_batch(specs, cfg, W0)
        _sync(dev)
    finally:
        torch.distributed.destroy_process_group()
    dU = float((res.U - ref.U).abs().max())
    return {
        "B": int(specs.x0.shape[0]), "backend": backend,
        "mesh_devices": [str(d) for d in mesh.devices],
        "converged": int((res.status == ipm.STATUS_CONVERGED).sum()),
        "wall_s": wall,
        "status_equal": bool(torch.equal(res.status, ref.status)),
        "iters_equal": bool(torch.equal(res.iters, ref.iters)),
        "max_abs_dU": dU, "bitwise": bool(torch.equal(res.U, ref.U)),
        "metrics": {k: float(v) for k, v in met.items()},
        "local_metrics": local_metrics(res),
        "launches": launches,
    }, res


def check_sharded(out):
    """Phase 11's gates."""
    if not (out["status_equal"] and out["iters_equal"]):
        raise RuntimeError(f"sharded solve: statuses or iterations differ "
                           f"from solve_batch: {out}")
    if not out["max_abs_dU"] <= SHARD_U_TOL:
        raise RuntimeError(f"sharded solve: max |dU| {out['max_abs_dU']:.3e}"
                           f" > {SHARD_U_TOL}")
    if out["metrics"] != {k: float(v)
                          for k, v in out["local_metrics"].items()}:
        raise RuntimeError(f"sharded solve: the reduced metrics "
                           f"{out['metrics']} are not the local ones "
                           f"{out['local_metrics']}")
    require_route("sharded solve", out["launches"], "bwd_matvec_se",
                  "bwd_se")


# One rank of phase 11p: joins a gloo group, solves its process_shard of
# the batch in an npz file (spec leaves under "/"-joined keys, W0 and
# max_iter) under f32_solver_config, and writes its lanes, their statuses,
# iterations and errors, the all-reduced metrics and its launch counts.
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


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run_shard_workers(specs, W0, max_iter, n_ranks=2,
                      timeout=SHARD_WORKER_TIMEOUT):
    """Phase 11p: ``n_ranks`` worker processes over gloo on the batch's
    device, each solving its ``process_shard`` of exactly phase 11's
    inputs (written to a temporary npz file).  A worker that fails, exits
    non-zero or outlives ``timeout`` fails the phase; every worker is
    stopped before this returns.  Returns each rank's outputs."""
    import tempfile

    from obca_torch.convert import to_numpy_tree

    device = str(specs.x0.device)
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "batch.npz")
        np.savez(inp, W0=W0.cpu().numpy(), max_iter=max_iter,
                 **_flat_tree(to_numpy_tree(specs)))
        port = str(free_port())
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(n_ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", SHARD_WORKER, str(r), str(n_ranks), port,
             ROOT, inp, outs[r], device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(n_ranks)]
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    raise RuntimeError(f"shard worker {r} exited "
                                       f"{p.returncode}:\n{out}\n"
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
    return ranks


def summarize_shard_workers(ranks, res11):
    """Phase 11p's numbers: each rank's reduced metrics, the union of
    the ranks' lanes, and the union against phase 11's result on the
    lanes converged in both."""
    from obca_torch.solver import ipm

    order = np.argsort([int(d["lo"]) for d in ranks])
    ranks = [ranks[i] for i in order]
    status = np.concatenate([d["status"] for d in ranks])
    U = np.concatenate([d["U"] for d in ranks])
    ok = status == ipm.STATUS_CONVERGED
    ok11 = res11.status.cpu().numpy() == ipm.STATUS_CONVERGED
    both = ok & ok11
    gap = (float(np.abs(U[both] - res11.U.cpu().numpy()[both]).max())
           if both.any() else None)
    launches = {}
    for d in ranks:
        for k, v in d["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {
        "ranks": len(ranks), "lanes": [int(d["status"].shape[0])
                                       for d in ranks],
        "reduced_n_converged": [int(d["n_converged"]) for d in ranks],
        "reduced_max_err": [float(d["max_err"]) for d in ranks],
        "rank_max_err": [float(d["err"].max()) for d in ranks],
        "union_converged": int(ok.sum()),
        "phase11_converged": int(ok11.sum()),
        "converged_in_both": int(both.sum()),
        "max_abs_dU_vs_phase11": gap,
        "iters_equal_phase11": bool(np.array_equal(
            np.concatenate([d["iters"] for d in ranks]),
            res11.iters.cpu().numpy())),
        "launches": launches,
    }


def check_shard_workers(out):
    """Phase 11p's gates."""
    if set(out["reduced_n_converged"]) != {out["union_converged"]}:
        raise RuntimeError(f"shard workers: reduced n_converged "
                           f"{out['reduced_n_converged']} is not the union's "
                           f"{out['union_converged']}")
    if set(out["reduced_max_err"]) != {max(out["rank_max_err"])}:
        raise RuntimeError(f"shard workers: reduced max_err "
                           f"{out['reduced_max_err']} is not the larger "
                           f"rank's {max(out['rank_max_err'])}")
    least = out["phase11_converged"] - SHARD_COUNT_SLACK
    if out["union_converged"] < least:
        raise RuntimeError(f"shard workers: {out['union_converged']} lanes "
                           f"converged, fewer than {least}")
    gap = out["max_abs_dU_vs_phase11"]
    if gap is None or not gap <= PARITY_TOL:
        raise RuntimeError(f"shard workers: U is {gap} from phase 11 on the "
                           f"lanes converged in both")
    require_route("shard workers", out["launches"], "bwd_matvec_se",
                  "bwd_se")


def run_cyclic(bk, device, B=B_MAIN, nw=None, nc=None, sizes=CR_SIZES):
    """Phase 12: ``obca_torch.tools.bench_cyclic`` at the main path's
    width (nz = 56: nw = 31, nc = 25) over ``sizes``, counted.  Returns
    (rows, verdict, launches)."""
    from obca_torch import nlp, reverse_parking_spec
    from obca_torch.tools import bench_cyclic

    if nw is None:
        L = nlp.layout_of(reverse_parking_spec(N=N_MAIN, Ts=TS_MAIN,
                                               device="cpu"))
        nw, nc = L.nw, L.nc
    bk.reset_launches()
    rows, verdict = bench_cyclic.main(nw, nc, B, sizes, device=device)
    return rows, verdict, dict(bk.launches)


def check_cyclic(rows, launches):
    """Phase 12's gates."""
    for r in rows:
        if not (r["finite"] and r["rel_diff_f64"] <= CR_TOL_F64
                and r["rel_diff_f32"] <= SYNTH_TOL):
            raise RuntimeError(f"cyclic reduction disagrees: {r}")
    for name in ("factor_dense", "fwd_dense", "bwd_dense"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the "
                               f"cyclic bench")


def run_debug(device, n_iter=DEBUG_ITERS):
    """Phase 13: ``ipm.debug_iterate`` on the golden
    ``reverse_parking_N80`` warm start at B=1 under
    ``f32_solver_config()`` for ``n_iter`` iterations (its lines
    collected), the debug step's diagnostics of the same iterations, and
    ``n_iter`` plain steps of the same ``_make_step``.  Returns (summary,
    the printed lines)."""
    import torch
    import obca_torch as ot
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm

    gold = np.load(os.path.join(ROOT, "oracle", "goldens",
                                "reverse_parking_N80.npz"))
    cfg = ot.f32_solver_config()
    spec = ot.reverse_parking_spec(N=int(gold["N"]), Ts=float(gold["Ts"]),
                                   dtype=cfg.dtype, device=device)
    W0 = torch.as_tensor(gold["W0"], dtype=cfg.dtype, device=device)
    lines = []
    t0 = time.perf_counter()
    state = ipm.debug_iterate(spec, cfg, W0, n_iter=n_iter,
                              printer=lines.append)
    _sync(device)
    wall = time.perf_counter() - t0

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
    finite = all(bool(torch.isfinite(v.float()).all()) for v in values)
    W = state.W.double()
    rel = float((W - plain.W[0].double()).abs().max() / W.abs().max())
    return {
        "iterations": n_iter, "lines": len(lines), "wall_s": wall,
        "rel_diff_vs_plain": rel,
        "bitwise": bool(torch.equal(state.W, plain.W[0])),
        "diag_values": len(values), "diag_finite": finite,
        "linres": [float(d["linres"][0]) for d in diags],
    }, lines


def check_debug(out):
    """Phase 13's gates."""
    if not out["rel_diff_vs_plain"] <= DEBUG_TOL:
        raise RuntimeError(f"debug_iterate is {out['rel_diff_vs_plain']:.3e}"
                           f" from the plain steps")
    if not out["diag_finite"] or out["lines"] != 2 * out["iterations"]:
        raise RuntimeError(f"debug_iterate: {out}")


class PhaseClock:
    """Prints the seconds of each phase as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.t:.1f} s")
        self.t = now


def check_errors(label, res):
    """Raise unless every output in ``res`` is finite and within
    SYNTH_TOL (relative) of its plain version."""
    for name, d in res.items():
        for what, (_abs, rel, finite) in (
                (k, v) for k, v in d.items() if isinstance(v, tuple)):
            if not finite or rel > SYNTH_TOL:
                raise RuntimeError(f"{label} {name}.{what} disagrees with "
                                   f"its plain version: rel err {rel:.3e}")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from obca_torch import (f32_solver_config, mixed_solver_config, nav,
                            nlp, parallel_fastpath_config)
    from obca_torch.solver import ipm
    from obca_torch.solver.kernels import blocktri_dense as bd
    from obca_torch.solver.kernels import blocktri_se as bk
    from obca_torch.solver.kernels import build
    from obca_torch.tools import kernel_bench as kb
    from obca_torch.warmstart import geometric, lattice

    device = torch.device("cuda", 0)
    clock = PhaseClock()

    # 1. The card.
    print(kb.card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. Build.
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build_s {time.perf_counter() - t0:.1f}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    clock.lap("1-2")

    # 3a. Kernels against their plain versions: synthetic systems.
    base, specs = main_path_batch(device)
    L = nlp.layout_of(base)
    rows, cols = nlp.coupling_structure(L)
    pat = bk.CouplingPattern.of(rows, cols)
    S, nz, nnz, C = L.N + 1, L.nz, len(rows), len(pat.ucols)
    K_syn, ev_syn, reg_syn, r_syn = synthetic_system(B_MAIN, S, L.nw, L.nc,
                                                     nnz)
    synth = compare_kernels(bk, pat, K_syn, ev_syn, reg_syn, r_syn, device,
                            timing=True)
    synth.update(compare_dense_kernels(
        bd, K_syn, synthetic_dense_e(B_MAIN, S, nz), reg_syn, r_syn, device,
        timing=True))
    print_errors("synthetic", synth)
    costs = kb.kernel_costs(B_MAIN, S, nz, nnz, C)
    bounds = {name: kb.bound_ms(*c) for name, c in costs.items()}
    check_errors("synthetic", synth)
    for name, d in synth.items():
        print(f"time {name}: kernel {d['ms']:.4f} ms, {device_text(d)}, "
              f"plain {d['plain_ms']:.4f} ms, bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})")
    launches = {name: 0 for name in KERNELS}
    clock.lap("3")

    # 3w. The wide instantiations (64 < nz <= 128) at nz = 72.
    wide, wide_inter, (nz_w, nnz_w, C_w) = compare_wide_kernels(bk, bd,
                                                                device)
    print_errors("wide synthetic", wide)
    for kind, res_k in wide_inter.items():
        print_errors(f"wide {kind}", res_k)
        check_errors(f"wide {kind}", res_k)
    check_errors("wide synthetic", wide)
    wide_bounds = {name: kb.bound_ms(*c) for name, c in kb.kernel_costs(
        B_MAIN, S, nz_w, nnz_w, C_w).items()}
    for name, d in wide.items():
        print(f"time nz={nz_w} {name}: kernel {d['ms']:.4f} ms, "
              f"{device_text(d)}, plain {d['plain_ms']:.4f} ms, bound "
              f"{wide_bounds[name][0]:.4f} ms ({wide_bounds[name][1]})")
    clock.lap("3w")

    # 3b. The kernel bench: its probe kernels against their plain
    # versions, then the bench itself, counted.
    probe_res = compare_probes(device, (B_MAIN, S, nz, nz))
    check_probes(probe_res)
    for name, d in probe_res.items():
        print(f"time {name}: kernel {d['ms']:.4f} ms, {device_text(d)}, "
              f"plain {d['plain_ms']:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})"
              + (f", x + 1 {d['library_ms']:.4f} ms"
                 if "library_ms" in d else ""))
    synth.update(probe_res)
    bk.reset_launches()
    bench = kb.measure(B_MAIN, N_MAIN, 50, device)
    for name in ("stream_add_one", "fma_probe"):
        if bk.launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the "
                               f"kernel bench")
        launches[name] += bk.launches[name]
    print("kernel_bench " + json.dumps(bench))
    for name, d in synth.items():
        t = kb.measured_bound_ms(*costs[name], bench["cuda_stream_gbps"],
                                 bench["fma_probe_tflops"])
        share = ("its device time not measured" if d["device_ms"] is None
                 else f"{100 * t / d['device_ms']:.1f}% of its device time")
        print(f"measured_bound {name}: {t:.4f} ms at the measured stream "
              f"and FMA rates, {share}")
    clock.lap("3b")

    # 4. The f32 main path.
    cfg = f32_solver_config(max_iter=ITERS_MAIN)
    main_f32, cap = measure_main_path(bk, base, specs, cfg)
    print("main_path " + json.dumps(main_f32))
    require_route("main path", main_f32["launches"], "bwd_matvec_se",
                  "bwd_se")
    for name, n in main_f32["launches"].items():
        launches[name] += n
    kernel_s = sum(n * synth[k]["ms"]
                   for k, n in main_f32["launches"].items()) / 1e3
    print(f"main path: kernels ~{kernel_s:.3f} s of "
          f"{main_f32['wall_s']:.3f} s wall (launches x synthetic median "
          f"time)")
    clock.lap("4")

    # 3c. Kernels against their plain versions: the main path's real
    # first-iteration system (Ruiz-scaled, as the solver factors it).
    Kr, evr, regr, patr = cap.system
    real = compare_kernels(bk, patr, Kr, evr, regr, cap.rhs, device,
                           timing=False)
    print_errors("first-iteration", real)
    for name, d in real.items():
        for what, v in d.items():
            if not v[2]:
                raise RuntimeError(f"{name}.{what} is not finite on the "
                                   f"first-iteration system")
    print("first-iteration accuracy " + json.dumps(
        stage_inverse_accuracy(bk, patr, L.nw, Kr, evr, regr)))
    clock.lap("3c")

    # 5. Parity against the float64 golden.
    gap, g_status, g_iters, _ = parity_gap(device, "reverse_parking_N80",
                                           f32_solver_config())
    print(f"parity_gap_vs_oracle {gap:.3e} status {g_status} "
          f"iters {g_iters}")
    if not gap < PARITY_TOL:
        raise RuntimeError(f"parity gap {gap:.3e} >= {PARITY_TOL}")
    clock.lap("5")

    # 6d. The dense-coupling solver against the structured one on the
    # f32 main path's first-iteration system.
    bk.reset_launches()
    dense = dense_vs_structured(bk, L.nw, rows, cols, Kr, evr, regr,
                                cap.rhs)
    dense["launches"] = dict(bk.launches)
    print("dense_vs_structured " + json.dumps(dense))
    if not dense["finite"] or not dense["d_rel_diff"] <= DENSE_TOL:
        raise RuntimeError(f"dense-coupling solve disagrees: {dense}")
    for name in ("factor_dense", "fwd_dense", "bwd_dense"):
        if dense["launches"][name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by "
                               f"make_kkt_solver")
    for name, n in dense["launches"].items():
        launches[name] += n
    clock.lap("6d")

    # 4m. The mixed-precision main path (bench.py's BENCH_DTYPE=mixed).
    base64, specs64 = main_path_batch(device, dtype=torch.float64)
    cfg_m = mixed_solver_config(max_iter=ITERS_MAIN)
    main_m, cap_m = measure_main_path(bk, base64, specs64, cfg_m)
    print("main_path_mixed " + json.dumps(main_m))
    lm = main_m["launches"]
    require_route("mixed main path", lm, "bwd_se", "bwd_matvec_se")
    for name, n in lm.items():
        launches[name] += n
    print_profile("mixed main path",
                  lambda: run_main_path(base64, specs64, cfg_m),
                  statistics.median(main_m["wall_s_runs"]))
    Km, evm, regm, patm = cap_m.system
    Sinv_m, Wc_m = bk.factor_se(Km, evm, regm, patm)
    x_m = bk.solve_se(Sinv_m, Wc_m, evm, cap_m.rhs, patm)
    x_mp = bk.solve_se_plain(Sinv_m, Wc_m, evm, cap_m.rhs, patm)
    _sync(device)
    solve_err = err(x_m, x_mp)
    print(f"mixed first-iteration solve_se: max_abs_err {solve_err[0]:.3e} "
          f"max_rel_err {solve_err[1]:.3e} finite {solve_err[2]}")
    if not solve_err[2] or solve_err[1] > SYNTH_TOL:
        raise RuntimeError(f"solve_se disagrees with its plain version on "
                           f"the mixed first-iteration system: {solve_err}")
    clock.lap("4m")

    # 5m. Mixed parity against the float64 goldens.
    for golden, cfg_p, signed in (
            ("reverse_parking_N80", mixed_solver_config(), True),
            ("reverse_parking_dist_N80", mixed_solver_config(max_iter=200),
             False)):
        gap, g_status, g_iters, _ = parity_gap(device, golden, cfg_p,
                                               signed)
        print(f"mixed_parity_gap {golden} {gap:.3e} status {g_status} "
              f"iters {g_iters}")
        if not gap < PARITY_TOL:
            raise RuntimeError(f"mixed parity gap {golden} {gap:.3e} >= "
                               f"{PARITY_TOL}")
    clock.lap("5m")

    # 7. The topology-varied reverse family at full width (nz = 72).
    specs_r, layouts_r, lcfg_r = random_family_batch(device, "reverse",
                                                     B_MAIN, 8)
    if nlp.layout_of(specs_r).nz != nz_w:
        raise RuntimeError("the reverse family is not at the wide nz")
    cfg_r = f32_solver_config(max_iter=ITERS_RANDOM)
    fam = measure_random_family(bk, specs_r, layouts_r, lcfg_r, cfg_r,
                                RANDOM_REPEATS)
    print("random_reverse " + json.dumps(fam))
    require_route("random reverse", fam["launches"], "bwd_matvec_se",
                  "bwd_se")
    for name, n in fam["launches"].items():
        launches[name] += n
    check_random_family("random_reverse", fam, RANDOM_MIN_CONVERGED)
    print_profile("random reverse",
                  lambda: run_grouped(specs_r, layouts_r, lcfg_r, cfg_r),
                  fam["wall_s_median"])
    clock.lap("7")

    # 8p. The parallel family: golden parity, then a randomized batch.
    gap, g_status, g_iters, _ = parity_gap(
        device, "parallel_parking_N80", parallel_fastpath_config(),
        family="parallel")
    print(f"parallel_parity_gap {gap:.3e} status {g_status} "
          f"iters {g_iters}")
    if not gap < PARITY_TOL:
        raise RuntimeError(f"parallel parity gap {gap:.3e} >= "
                           f"{PARITY_TOL}")
    specs_p, layouts_p, lcfg_p = random_family_batch(device, "parallel",
                                                     B_PARALLEL, 4)
    cfg_par = f32_solver_config(max_iter=ITERS_PARALLEL, mu_init=1e-3,
                                delta_w=1e-4)
    bk.reset_launches()
    res_p, secs_p = run_grouped(specs_p, layouts_p, lcfg_p, cfg_par)
    par = summarize(specs_p, res_p, secs_p)
    par["launches"] = dict(bk.launches)
    print("random_parallel " + json.dumps(par))
    for name, n in par["launches"].items():
        launches[name] += n
    check_random_family("random_parallel", par, PARALLEL_MIN_CONVERGED)
    clock.lap("8p")

    # 8f. Free time against its float64 golden.
    gap, g_status, g_iters, dtau = parity_gap(
        device, "reverse_parking_freetime_N80",
        f32_solver_config(max_iter=ITERS_PARALLEL))
    print(f"free_time_parity_gap {gap:.3e} tau_gap {dtau:.3e} status "
          f"{g_status} iters {g_iters}")
    if not gap < PARITY_TOL:
        raise RuntimeError(f"free-time parity gap {gap:.3e} >= "
                           f"{PARITY_TOL}")
    clock.lap("8f")

    # 9. The MPC fleet at full width (bench/run_mpc.py's defaults).
    base_mpc, specs_mpc = mpc_fleet_batch(device)
    cfg_mpc = f32_solver_config(max_iter=ITERS_MPC)
    bk.reset_launches()
    res_mpc, wall_mpc = run_mpc_fleet(base_mpc, specs_mpc, cfg_mpc,
                                      MPC_STEPS)
    fleet = summarize_mpc(specs_mpc, res_mpc, wall_mpc)
    fleet["launches"] = dict(bk.launches)
    print("mpc_fleet " + json.dumps(fleet))
    require_route("mpc fleet", fleet["launches"], "bwd_matvec_se", "bwd_se")
    for name, n in fleet["launches"].items():
        launches[name] += n
    check_mpc(fleet)
    clock.lap("9")

    # 9s. One vehicle: rollout 0 alone, and the steady per-period time.
    single, cap_mpc = measure_mpc_single(bk, base_mpc, specs_mpc, cfg_mpc)
    print("mpc_single " + json.dumps(single))
    require_route("mpc single", single["launches"], "bwd_matvec_se",
                  "bwd_se")
    for name, n in single["launches"].items():
        launches[name] += n
    compare_captured(bk, "mpc single re-solve", cap_mpc.last_system,
                     cap_mpc.last_rhs, device, F32_ROUTE)
    run_one = check_mpc_run(bk, base_mpc, specs_mpc, cfg_mpc)
    print("mpc_run " + json.dumps(run_one))
    require_route("mpc run", run_one["launches"], "bwd_matvec_se", "bwd_se")
    for name, n in run_one["launches"].items():
        launches[name] += n
    clock.lap("9s")

    # 10. Point-mass navigation at full width, mixed precision.
    # The counted run is the main path (its turns from the second
    # replayed as CUDA graphs) and captures its first IPM iteration's
    # system; an eager solve of the same batch captures the last one (a
    # rescue round's, at fewer lanes, when one ran) and must equal the
    # counted run bit for bit.
    _, specs_nav = nav_batch(device)
    cfg_nav = mixed_solver_config(max_iter=ITERS_NAV)
    bk.reset_launches()
    t0 = time.perf_counter()
    with FirstIterationCapture(bk) as cap_nav:
        res_nav = ipm.solve_batch_rescued(specs_nav, cfg_nav, prob=nav)
        _sync(device)
    nav_out = summarize_nav(specs_nav, res_nav, time.perf_counter() - t0)
    nav_out["launches"] = dict(bk.launches)
    require_route("nav", nav_out["launches"], "bwd_se", "bwd_matvec_se")
    for name, n in nav_out["launches"].items():
        launches[name] += n
    with FirstIterationCapture(bk, keep_last=True) as cap_last:
        res_eager = ipm.solve_batch_rescued(specs_nav, cfg_nav, prob=nav)
    nav_out["eager_bitwise"] = same_result(res_nav, res_eager)
    compare_captured(bk, "nav first-iteration", cap_nav.system, cap_nav.rhs,
                     device, MIXED_ROUTE)
    compare_captured(bk, "nav last iteration", cap_last.last_system,
                     cap_last.last_rhs, device, MIXED_ROUTE)
    gap, g_status, g_iters = nav_cpu_gap(specs_nav, res_nav)
    nav_out["lane0_cpu_gap"] = gap
    print("nav " + json.dumps(nav_out))
    print(f"nav_cpu_gap {gap:.3e} lane 0 status {int(res_nav.status[0])} "
          f"iters {int(res_nav.iters[0])}; cpu float64 status {g_status} "
          f"iters {g_iters}")
    check_nav(nav_out, int(res_nav.status[0]))
    clock.lap("10")

    # 11. The f32 main path sharded over a one-rank NCCL group: phase 4's
    # batch from its lattice warm starts, solve_sharded beside
    # solve_batch.
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0_sh = geometric.lattice_warm_start(
        specs, dtype=base.x0.dtype, cfg=lcfg,
        field=lattice.plan_field(base, lcfg))
    sharded, res_sh = run_sharded(bk, specs, W0_sh,
                                  f32_solver_config(max_iter=ITERS_MAIN))
    print("sharded " + json.dumps(sharded))
    print(f"sharded max |dU| vs solve_batch {sharded['max_abs_dU']:.3e} "
          f"bitwise {sharded['bitwise']}")
    check_sharded(sharded)
    for name, n in sharded["launches"].items():
        launches[name] += n
    clock.lap("11")

    # 11p. Two ranks over gloo on this one card, each on its
    # process_shard of exactly phase 11's inputs.
    workers = summarize_shard_workers(
        run_shard_workers(specs, W0_sh, ITERS_MAIN), res_sh)
    print("shard_workers " + json.dumps(workers))
    check_shard_workers(workers)
    for name, n in workers["launches"].items():
        launches[name] += n
    clock.lap("11p")

    # 12. Cyclic reduction against the dense kernels (f32) and the plain
    # sequential blocktri (f64) at the main path's width, counted.
    rows, verdict, cr_launches = run_cyclic(bk, device)
    check_cyclic(rows, cr_launches)
    for name, n in cr_launches.items():
        launches[name] += n
    clock.lap("12")

    # 13. debug_iterate on the card.
    dbg, lines = run_debug(device)
    print(f"debug_iterate first line: {lines[0]}")
    print(f"debug_iterate last line: {lines[-1]}")
    print("debug_iterate " + json.dumps(dbg))
    check_debug(dbg)
    clock.lap("13")

    # 6. The kernels line, then the device line.
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"obca_torch/solver/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v[0] for v in synth[name].values()
                               if isinstance(v, tuple)),
            "ms": synth[name]["ms"], "device_ms": synth[name]["device_ms"],
            "plain_ms": synth[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": synth[name].get("library_ms"),
        })
        if name in wide:
            kernels[-1][f"nz{nz_w}"] = {
                "max_abs_err": max(v[0] for v in wide[name].values()
                                   if isinstance(v, tuple)),
                "ms": wide[name]["ms"],
                "device_ms": wide[name]["device_ms"],
                "plain_ms": wide[name]["plain_ms"],
                "bound_ms": wide_bounds[name][0],
                "bound_by": wide_bounds[name][1]}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
