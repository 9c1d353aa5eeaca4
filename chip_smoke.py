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
   kernels must have launched), two more timed runs for the spread, and
   one under torch.profiler for the device's busy share and the kernels
   that take its time;
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
6. one ``kernels`` JSON line (launches summed over the counted runs of
   phases 3b, 4, 6d and 4m), then the device line, last.

It imports nothing of JAX and nothing of ``obca_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

B_MAIN, N_MAIN, TS_MAIN, ITERS_MAIN = 128, 80, 0.3, 55
SYNTH_TOL = 1e-4
PROBE_ULPS = 2
PARITY_TOL = 1e-3
DENSE_TOL = 1e-3
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
    passing every call through to the real wrapper."""

    def __init__(self, bk):
        self.bk = bk
        self.n_factor = 0
        self.system = None
        self.rhs = None
        self._factor, self._fwd = bk.factor_se, bk.fwd_se

    def __enter__(self):
        def factor(K, ev, reg, pat):
            self.n_factor += 1
            if self.n_factor == 2:
                self.system = (K.clone(), ev.clone(), reg.clone(), pat)
            return self._factor(K, ev, reg, pat)

        def fwd(Sinv, ev, r, pat):
            if self.system is not None and self.rhs is None:
                self.rhs = r.clone()
            return self._fwd(Sinv, ev, r, pat)

        self.bk.factor_se, self.bk.fwd_se = factor, fwd
        return self

    def __exit__(self, *exc):
        self.bk.factor_se, self.bk.fwd_se = self._factor, self._fwd


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
    is the sum of kernel times (one stream, no overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def parity_gap(device, golden, cfg, signed=True):
    """max |U - U_gold| of ``cfg``'s solve of one golden instance from its
    warm start, in the configuration's iterate dtype, with the solve's
    status and iterations."""
    import torch
    from obca_torch import reverse_parking_spec
    from obca_torch.solver import ipm

    gold = np.load(os.path.join(ROOT, "oracle", "goldens",
                                f"{golden}.npz"))
    spec = reverse_parking_spec(N=int(gold["N"]), Ts=float(gold["Ts"]),
                                signed=signed, dtype=cfg.dtype,
                                device=device)
    W0 = torch.as_tensor(gold["W0"], dtype=cfg.dtype, device=device)
    res = ipm.solve_single(spec, cfg, W0)
    gap = float(np.abs(res.U.double().cpu().numpy() - gold["U"]).max())
    return gap, int(res.status), int(res.iters)


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


def print_profile(label, base, specs, cfg, wall_median):
    p_wall, p_busy, p_top, p_ours = device_profile(
        lambda: run_main_path(base, specs, cfg))
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


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from obca_torch import f32_solver_config, mixed_solver_config, nlp
    from obca_torch.solver.kernels import blocktri_dense as bd
    from obca_torch.solver.kernels import blocktri_se as bk
    from obca_torch.solver.kernels import build
    from obca_torch.tools import kernel_bench as kb

    device = torch.device("cuda", 0)

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
    for name, d in synth.items():
        for what, (_abs, rel, finite) in (
                (k, v) for k, v in d.items() if isinstance(v, tuple)):
            if not finite or rel > SYNTH_TOL:
                raise RuntimeError(f"{name}.{what} disagrees with its plain "
                                   f"version: rel err {rel:.3e}")
        print(f"time {name}: kernel {d['ms']:.4f} ms, device "
              f"{d['device_ms']:.4f} ms ({d['device_launches']:g} "
              f"launches a call), plain {d['plain_ms']:.4f} ms, bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})")
    launches = {name: 0 for name in KERNELS}

    # 3b. The kernel bench: its probe kernels against their plain
    # versions, then the bench itself, counted.
    probe_res = compare_probes(device, (B_MAIN, S, nz, nz))
    check_probes(probe_res)
    for name, d in probe_res.items():
        print(f"time {name}: kernel {d['ms']:.4f} ms, device "
              f"{d['device_ms']:.4f} ms, plain {d['plain_ms']:.4f} ms, "
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
        print(f"measured_bound {name}: {t:.4f} ms at the measured stream "
              f"and FMA rates, {100 * t / d['device_ms']:.1f}% of its "
              f"device time")

    # 4. The f32 main path.
    cfg = f32_solver_config(max_iter=ITERS_MAIN)
    main_f32, cap = measure_main_path(bk, base, specs, cfg)
    print("main_path " + json.dumps(main_f32))
    for name in ("factor_se", "fwd_se", "bwd_matvec_se"):
        if main_f32["launches"][name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               f"main path")
    for name, n in main_f32["launches"].items():
        launches[name] += n
    kernel_s = sum(n * synth[k]["ms"]
                   for k, n in main_f32["launches"].items()) / 1e3
    print(f"main path: kernels ~{kernel_s:.3f} s of "
          f"{main_f32['wall_s']:.3f} s wall (launches x synthetic median "
          f"time)")
    print_profile("main path", base, specs, cfg,
                  statistics.median(main_f32["wall_s_runs"]))

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

    # 5. Parity against the float64 golden.
    gap, g_status, g_iters = parity_gap(device, "reverse_parking_N80",
                                        f32_solver_config())
    print(f"parity_gap_vs_oracle {gap:.3e} status {g_status} "
          f"iters {g_iters}")
    if not gap < PARITY_TOL:
        raise RuntimeError(f"parity gap {gap:.3e} >= {PARITY_TOL}")

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

    # 4m. The mixed-precision main path (bench.py's BENCH_DTYPE=mixed).
    base64, specs64 = main_path_batch(device, dtype=torch.float64)
    cfg_m = mixed_solver_config(max_iter=ITERS_MAIN)
    main_m, cap_m = measure_main_path(bk, base64, specs64, cfg_m)
    print("main_path_mixed " + json.dumps(main_m))
    lm = main_m["launches"]
    if min(lm["factor_se"], lm["fwd_se"], lm["bwd_se"]) <= 0 \
            or lm["bwd_matvec_se"] != 0:
        raise RuntimeError(f"the mixed route did not run: launches {lm}")
    for name, n in lm.items():
        launches[name] += n
    print_profile("mixed main path", base64, specs64, cfg_m,
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

    # 5m. Mixed parity against the float64 goldens.
    for golden, cfg_p, signed in (
            ("reverse_parking_N80", mixed_solver_config(), True),
            ("reverse_parking_dist_N80", mixed_solver_config(max_iter=200),
             False)):
        gap, g_status, g_iters = parity_gap(device, golden, cfg_p, signed)
        print(f"mixed_parity_gap {golden} {gap:.3e} status {g_status} "
              f"iters {g_iters}")
        if not gap < PARITY_TOL:
            raise RuntimeError(f"mixed parity gap {golden} {gap:.3e} >= "
                               f"{PARITY_TOL}")

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
