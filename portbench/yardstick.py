"""The benchmark's own yardsticks: the card's published peaks, the least
bytes and operations of each solver kernel at its shapes, and the
reduction of a profiler trace to busy time, top device operations and
idle gaps.

The kernel costs are a frozen copy of the port's kernel bench
(``obca_torch/tools/kernel_bench.py``: ``kernel_costs`` and
``bound_ms``), kept here so that a later change to the program cannot
move the yardstick it is measured by.
"""

from __future__ import annotations

import bisect

# NVIDIA's data sheet for the H100 SXM part at its 700 W limit: HBM3 at
# 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def kernel_costs(B, S, nz, nnz, C):
    """(bytes, operations) each kernel must at least move / do at these
    shapes: every input read once, every output written once (f32 data,
    int32 pattern)."""
    f, i = 4, 4
    K = B * S * nz * nz * f
    ev = B * (S - 1) * nnz * f
    vec = B * S * nz * f
    Wc = B * (S - 1) * nz * C * f
    E = B * (S - 1) * nz * nz * f
    return {
        "factor_se": (
            K + ev + B * nz * f + (2 * nnz + C) * i + K + Wc,
            B * S * 2 * nz ** 3
            + B * (S - 1) * (2 * nz * nnz + 2 * nnz * C)),
        "fwd_se": (
            K + ev + vec + 2 * nnz * i + vec,
            B * S * 2 * nz * nz + B * (S - 1) * 2 * nnz),
        "bwd_matvec_se": (
            Wc + vec + K + ev + (4 * nnz + C + 2 * (nz + 1)) * i + 2 * vec,
            B * S * 2 * nz * nz + B * (S - 1) * (2 * nz * C + 4 * nnz)),
        "bwd_se": (
            Wc + vec + C * i + vec,
            B * (S - 1) * 2 * nz * C),
        "factor_dense": (
            K + E + K + E,
            B * S * 2 * nz ** 3 + B * (S - 1) * 2 * 2 * nz ** 3),
        "fwd_dense": (
            K + E + vec + vec,
            B * S * 2 * nz * nz + B * (S - 1) * 2 * nz * nz),
        "bwd_dense": (
            E + vec + vec,
            B * (S - 1) * 2 * nz * nz),
    }


def bound_s(nbytes, ops):
    """The least time the card could take: bytes at its memory rate or
    float32 operations at its peak, whichever is longer (seconds)."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def device_events(prof):
    """(name, start ns, end ns) of every operation the profiler saw run
    on the device, in start order (host wall-clock nanoseconds, the
    clock of ``time.time_ns``)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns()
                        + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def reduce_trace(events, t0_ns, t1_ns, spans, top=10):
    """Busy time, top device operations and longest idle gaps of device
    events [(name, start ns, end ns)] inside the window [t0_ns, t1_ns].

    Busy time is the length of the union of the operations' intervals
    (clipped to the window).  An idle gap is a stretch of the window in
    which no operation ran; it is named by the host span [(name, start
    ns, end ns), ...] in which it began ("other" outside every span).
    ``idle_gaps`` gives first each span's idle seconds in all
    ("<span>: all"), most first, then the longest single gaps.
    Returns {"busy_s", "window_s", "device_ops": [[name, s], ...],
    "idle_gaps": [[span, s], ...], "by_name": {name: s}}."""
    by_name = {}
    busy = 0
    gaps = []
    cursor = t0_ns
    for name, s, e in events:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1_ns > cursor:
        gaps.append((cursor, t1_ns))
    starts = [sp[1] for sp in spans]

    def span_of(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            name, s, e = spans[i]
            if s <= t < e:
                return name
            i -= 1
        return "other"

    named = [(span_of(a), (b - a) / 1e9) for a, b in gaps]
    totals = {}
    for name, s in named:
        totals[name] = totals.get(name, 0.0) + s
    named.sort(key=lambda g: g[1], reverse=True)
    idle = [[f"{n}: all", s] for n, s in
            sorted(totals.items(), key=lambda kv: kv[1], reverse=True)]
    idle += [[n, s] for n, s in named[:max(top - len(idle), 0)]]
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return {
        "busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
        "device_ops": [[n[:120], v] for n, v in ops[:top]],
        "idle_gaps": idle[:top], "by_name": by_name,
    }
