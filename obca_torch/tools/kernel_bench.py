"""Kernel bench: the structured-coupling kernels' times against a model
of their bytes and operations, and what this card streams and computes.

    python3 -m obca_torch.tools.kernel_bench [B] [N] [n_chain]

Port of ``tools/kernel_bench.py`` (JAX on a TPU); defaults B=128, N=80,
n_chain=50.  It runs on the card; ``main(..., device="cpu")`` runs the
same steps through the plain versions on the CPU and reports no times
(a CPU run times PyTorch's CPU kernels, not the card).  In order:

1. that tool's synthetic system (:func:`synthetic_system`; not the
   card tests' ``full_size_batches.full_size_system``);
2. chained timing: ``n_chain`` calls of ``factor_se``, and of the solve
   (``fwd_se`` then ``bwd_se``), captured in one CUDA graph and replayed
   between two CUDA events, per call (``factor_ms``, ``solve_ms``);
3. device-trace timing: the same calls' own device time per call under
   torch.profiler (:func:`device_ms`; ``*_trace_ms``; where the profiler
   records no kernel, the chained time stands in, and
   ``untraced_timings`` counts those timings);
4. stream rate over a [B, S, nz, nz] float32 array (130.1 MB at the
   default shape, past the 50 MB L2), from the device time of ``NS``
   passes each: PyTorch's ``x + 1`` (``torch_stream_gbps``) and the
   hand-written stream kernel (``cuda_stream_gbps``); a reading above
   the card's 3.35 TB/s means the measurement is wrong, and raises;
5. float32 FMA rate of the FMA probe kernel, from its device time
   (``fma_probe_tflops``);
6. the factor and the solve against the data-sheet peaks
   (``*_pct_of_sol``, from :func:`kernel_costs` and :func:`bound_ms`)
   and, for information, against the measured stream and FMA rates
   (``*_pct_of_measured``);
7. one JSON line.

It also holds the one model of every kernel's bytes and operations and
the profiler helper that ``kernel_times.py`` and ``chip_smoke.py`` use.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from obca_torch import nlp, reverse_parking_spec
from obca_torch._util import resolve_device
from obca_torch.solver.kernels import blocktri_se as bk
from obca_torch.solver.kernels import probes

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

NS = 50         # passes of each stream probe
FMA_RUNS = 10   # calls of the FMA probe


def kernel_costs(B, S, nz, nnz, C):
    """(bytes, operations) each kernel must at least move / do at these
    shapes: every input read once, every output written once (f32 data,
    int32 pattern).  The probes run over one [B, S, nz, nz] array."""
    f, i = 4, 4
    K = B * S * nz * nz * f
    ev = B * (S - 1) * nnz * f
    vec = B * S * nz * f
    Wc = B * (S - 1) * nz * C * f
    E = B * (S - 1) * nz * nz * f
    n = B * S * nz * nz
    return {
        "factor_se": (
            K + ev + B * nz * f + (2 * nnz + C) * i + K + Wc,
            B * S * 2 * nz ** 3
            + B * (S - 1) * (2 * nz * nnz + 2 * nnz * C)),
        "fwd_se": (
            K + ev + vec + 2 * nnz * i + vec,
            B * S * 2 * nz * nz + B * (S - 1) * 2 * nnz),
        # rows, cols, ucols and the per-row coupling lists.
        "bwd_matvec_se": (
            Wc + vec + K + ev + (4 * nnz + C + 2 * (nz + 1)) * i + 2 * vec,
            B * S * 2 * nz * nz + B * (S - 1) * (2 * nz * C + 4 * nnz)),
        "bwd_se": (
            Wc + vec + C * i + vec,
            B * (S - 1) * 2 * nz * C),
        # Two stage products and one stage inverse, 2 nz^3 each.
        "factor_dense": (
            K + E + K + E,
            B * S * 2 * nz ** 3 + B * (S - 1) * 2 * 2 * nz ** 3),
        "fwd_dense": (
            K + E + vec + vec,
            B * S * 2 * nz * nz + B * (S - 1) * 2 * nz * nz),
        "bwd_dense": (
            E + vec + vec,
            B * (S - 1) * 2 * nz * nz),
        # Every input read once and K_s, ev_s, rhs_s, d written once;
        # three sweeps of |K_ij| d_j and its max, then two products.
        "ruiz_se": (
            K + ev + vec + (4 * nnz + 2 * (nz + 1)) * i + K + ev + 2 * vec,
            11 * n),
        "stream_add_one": (2 * n * f, n),
        "fma_probe": (2 * n * f, probes.FMA_PROBE_OPS * n),
    }


def bound_ms(nbytes, ops):
    """The least time the card could take (bytes at its memory rate or
    float32 operations at its peak, whichever is longer) and which of
    the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def measured_bound_ms(nbytes, ops, stream_gbps, fma_tflops):
    """The least time at the rates this card was measured to reach: bytes
    at the stream kernel's GB/s or operations at the FMA probe's TFLOP/s,
    whichever is longer."""
    return max(nbytes / (stream_gbps * 1e6), ops / (fma_tflops * 1e9))


def device_ms(fn, runs=25, tries=3):
    """The device's own time per call of ``fn``: the self device time of
    the CUDA kernels that ``runs`` calls launch under torch.profiler,
    over ``runs``, with those launches per call.  Unlike the CUDA-event
    time, it leaves out the host's launch gap.  A trace that records no
    CUDA kernel (one H100 run got such a trace for one kernel among many
    that were traced), or a number of kernels that
    is not a whole number a call, lost records; it is taken again, up
    to ``tries`` times, and if none is whole the device time was not
    measured and the result is (None, None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kern)
        count = sum(e.count for e in kern)
        if total_us > 0 and count % runs == 0:
            return total_us / 1e3 / runs, count / runs
    return None, None


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def synthetic_system(B, N, device):
    """The synthetic system of ``tools/kernel_bench.py``, drawn in the
    same order from ``np.random.default_rng(0)``, in the port's
    batch-major layout: the layout and coupling pattern of
    ``reverse_parking_spec(N, Ts=24/N)``; the same random SPD block A on
    the primal part of every lane's stage blocks, -1 on the constraint
    diagonal; ev = 0.3 N(0, 1), reg = 0, r ~ N(0, 1).  The reference
    draws ev and r at its padded shapes (stage rows rounded up to 8,
    lanes to 128); the same draws cut to nz rows and B lanes give the
    same values.  Returns float32 tensors K [B, S, nz, nz], ev [B, S-1,
    nnz], reg [B, nz], r [B, S, nz] on ``device`` and the pattern."""
    L = nlp.layout_of(reverse_parking_spec(N=N, Ts=24.0 / N,
                                           dtype=torch.float32,
                                           device="cpu"))
    rows, cols = nlp.coupling_structure(L)
    S, nw, nz, nnz = N + 1, L.nw, L.nz, len(rows)
    nz_drawn = -(-nz // 8) * 8
    b_drawn = -(-B // 128) * 128
    rng = np.random.default_rng(0)
    R = rng.standard_normal((S, nw, nw)).astype(np.float32)
    A = R @ np.swapaxes(R, -1, -2) / nw + 2.0 * np.eye(nw, dtype=np.float32)
    K = np.zeros((B, S, nz, nz), np.float32)
    K[:, :, :nw, :nw] = A
    idx = np.arange(nw, nz)
    K[:, :, idx, idx] = -1.0
    ev = 0.3 * rng.standard_normal((S - 1, nnz, b_drawn)).astype(np.float32)
    r = rng.standard_normal((S, nz_drawn, b_drawn)).astype(np.float32)
    ev = np.moveaxis(ev[..., :B], -1, 0)
    r = np.moveaxis(r[:, :nz, :B], -1, 0)
    reg = np.zeros((B, nz), np.float32)
    tensors = (torch.as_tensor(np.ascontiguousarray(a), device=device)
               for a in (K, ev, reg, r))
    return (*tensors, bk.CouplingPattern.of(rows, cols))


def chain_ms(fn, n_chain, device):
    """ms per call of ``n_chain`` calls of ``fn`` back to back on one
    stream, after a warm-up call.  On the card the calls are captured in
    one CUDA graph, replayed between two CUDA events, so no host launch
    gap separates them (the reference ran them in one jitted loop); on
    the CPU, the host clock."""
    fn()  # loads the kernel and caches the pattern's index tensors
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n_chain):
            fn()
        return 1e3 * (time.perf_counter() - t0) / n_chain
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_chain):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n_chain


def _shares(prefix, chained, trace, nbytes, ops, stream_gbps, fma_tflops):
    """The model of one chain (bytes, operations, bound) and what its
    measured times make of it."""
    sol, by = bound_ms(nbytes, ops)
    measured_bound = measured_bound_ms(nbytes, ops, stream_gbps, fma_tflops)
    model = {f"{prefix}_model_bytes_MB": nbytes / 1e6,
             f"{prefix}_model_gflop": ops / 1e9,
             f"{prefix}_sol_ms": sol, f"{prefix}_bound": by}
    measured = {f"{prefix}_ms": chained, f"{prefix}_trace_ms": trace,
                f"{prefix}_pct_of_sol": 100 * sol / trace,
                f"{prefix}_achieved_tflops": ops / trace / 1e9,
                f"{prefix}_pct_of_measured": 100 * measured_bound / trace}
    return model, measured


def measure(B=128, N=80, n_chain=50, device="cuda"):
    """Steps 1-6 of the module docstring; returns the result line."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    K, ev, reg, r, pat = synthetic_system(B, N, device)
    _, S, nz, _ = K.shape
    nnz, C = len(pat.rows), len(pat.ucols)
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)

    def factor():
        return bk.factor_se(K, ev, reg, pat)

    def solve():
        return bk.solve_se(Sinv, Wc, ev, r, pat)

    untraced = []

    def trace_ms(fn, runs):
        # The device's own time per call; on the CPU there is no device
        # trace, the host time stands in for it and is not reported.
        # Where the profiler records no kernel, the CUDA-graph time (on
        # the device's clock, with no host gap) stands in for it, and
        # ``untraced`` counts such timings.
        t = device_ms(fn, runs)[0] if cuda else None
        if t is None:
            untraced.append(fn)
            return chain_ms(fn, runs, device)
        return t

    times = {name: (chain_ms(fn, n_chain, device), trace_ms(fn, n_chain))
             for name, fn in (("factor", factor), ("solve", solve))}

    x = torch.randn((B, S, nz, nz), device=device,
                    generator=torch.Generator(device).manual_seed(0))
    stream_bytes = 2 * x.numel() * x.element_size()
    torch_gbps = stream_bytes / trace_ms(lambda: x + 1, NS) / 1e6
    cuda_gbps = stream_bytes / trace_ms(
        lambda: probes.stream_add_one(x), NS) / 1e6
    if cuda and max(torch_gbps, cuda_gbps) > PEAK_BYTES_PER_S / 1e9:
        raise RuntimeError(
            f"stream rate above the card's {PEAK_BYTES_PER_S / 1e9:.0f} "
            f"GB/s (torch {torch_gbps:.1f}, cuda {cuda_gbps:.1f}): the "
            f"array must not be resident in L2")
    costs = kernel_costs(B, S, nz, nnz, C)
    fma_tflops = costs["fma_probe"][1] / trace_ms(
        lambda: probes.fma_probe(x), FMA_RUNS) / 1e9

    out = {"B": B, "N": N, "n_chain": n_chain, "S": S, "nz": nz,
           "nnz": nnz, "C": C, "chain": "cuda_graph" if cuda else "host",
           "hbm_spec_gbps": PEAK_BYTES_PER_S / 1e9,
           "f32_spec_tflops": PEAK_F32_FLOPS / 1e12}
    measured = {"torch_stream_gbps": torch_gbps,
                "cuda_stream_gbps": cuda_gbps,
                "fma_probe_tflops": fma_tflops}
    for name, kernels in (("factor", ("factor_se",)),
                          ("solve", ("fwd_se", "bwd_se"))):
        nbytes = sum(costs[k][0] for k in kernels)
        ops = sum(costs[k][1] for k in kernels)
        m, t = _shares(name, *times[name], nbytes, ops, cuda_gbps,
                       fma_tflops)
        out.update(m)
        measured.update(t)
    measured["untraced_timings"] = len(untraced)
    if not cuda:
        measured = dict.fromkeys(measured)
    out.update(measured)
    out["device"] = card() if cuda else "cpu"
    return out


def main(B=128, N=80, n_chain=50, device="cuda"):
    """Run :func:`measure` and print its result as one JSON line."""
    out = measure(B, N, n_chain, device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
