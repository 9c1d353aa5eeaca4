"""The kernel bench's two probe kernels: CUDA wrappers and their plain
PyTorch versions.

``stream_add_one`` (out = x + 1) is the counterpart of the Pallas
stream probe ``_pstream_kernel`` of ``tools/kernel_bench.py``: what a
streaming kernel reaches on this card.  ``fma_probe`` is the
counterpart of that tool's ``fma_chain`` expression, which XLA fuses
into one kernel: 16 independent chains of 16 FMAs per element, the
card's float32 FMA throughput.  Neither runs on a solver path.

The wrappers follow the rules of ``runtime``: the plain version for a
tensor on the CPU; for a CUDA tensor float32, contiguity and device are
checked, the kernel is launched and counted in ``runtime.launches``, or
the call raises.
"""

from __future__ import annotations

import torch

from obca_torch.solver.kernels.runtime import check, launch, on_cpu

# fma_probe: independent chains per element, FMAs per chain.
N_CHAINS, CHAIN_LEN = 16, 16
# Its operations per element: the FMAs (two each), the chains' scaling
# multiplies and the N_CHAINS - 1 adds of their sum.
FMA_PROBE_OPS = 2 * N_CHAINS * CHAIN_LEN + N_CHAINS + (N_CHAINS - 1)


def stream_add_one_plain(x):
    """Plain version of :func:`stream_add_one`."""
    return x + 1


def fma_probe_plain(x):
    """Plain version of :func:`fma_probe`, with the kernel's rounding:
    y_i = x (1 + 1e-6 i) in float32 for 16 chains, then y_i = y_i
    1.0000001 + 1e-7 sixteen times, each rounded once to float32 as a
    fused multiply-add rounds it, then the chains summed in order in
    float32 (``fma_chain`` of ``tools/kernel_bench.py``).  Each step is
    taken in float64: the product of two floats is exact there, and so,
    for these constants, is the sum unless |y_i| < 2^-28; one rounding to
    float32 then gives what ``fmaf`` gives."""
    a = torch.tensor(1.0000001, dtype=torch.float32).double()
    b = torch.tensor(1e-7, dtype=torch.float32).double()
    ys = [x * torch.tensor(1.0 + 1e-6 * i, dtype=torch.float32)
          for i in range(N_CHAINS)]
    for _ in range(CHAIN_LEN):
        ys = [(y.double() * a + b).float() for y in ys]
    out = ys[0]
    for y in ys[1:]:
        out = out + y
    return out


def max_ulps(got, want):
    """The largest |got - want| over the elements, each in units of the
    last place of its float32 ``want``."""
    w = want.abs()
    ulp = torch.nextafter(w, torch.full_like(w, float("inf"))) - w
    return float(((got - want).abs() / ulp).max())


def _run(name, x):
    dev = x.device
    check(name, "x", x, tuple(x.shape), dev)
    out = torch.empty_like(x)
    launch(name, dev, x, out, x.numel())
    return out


def stream_add_one(x):
    """out = x + 1 over a float32 tensor of any shape."""
    if on_cpu("stream_add_one", x):
        return stream_add_one_plain(x)
    return _run("stream_add_one", x)


def fma_probe(x):
    """The FMA probe of :func:`fma_probe_plain` over a float32 tensor of
    any shape, with the chains in registers: x read once, the sum
    written once, 543 operations per element."""
    if on_cpu("fma_probe", x):
        return fma_probe_plain(x)
    return _run("fma_probe", x)
