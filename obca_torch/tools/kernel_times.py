"""Device time per call of the seven solver kernels, for comparing two
checkouts of this repository on one card.

    python3 obca_torch/tools/kernel_times.py [--root DIR] [--runs 25]

Imports ``obca_torch`` from the checkout at DIR (default: the one this
file is in), builds its kernels, runs each of the seven solver kernels
on the kernel bench's system (``kernel_bench.synthetic_system`` at
B=128, N=80: nz=56, the main paths' shape; a dense coupling block from
a seed for the dense kernels) and prints one JSON line: the card, the
checkout, and each kernel's device time per call from ``torch.profiler``
(``kernel_bench.device_ms``, ``runs`` calls).  Run it for two checkouts
in turns (A, B, B, A) on one card to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def measure(runs=25, B=128, N=80):
    """{kernel: device ms per call} on the current checkout's kernels."""
    import torch
    from obca_torch.solver.kernels import blocktri_dense as bd
    from obca_torch.solver.kernels import blocktri_se as bk
    from obca_torch.tools import kernel_bench as kb

    dev = torch.device("cuda", 0)
    K, ev, reg, r, pat = kb.synthetic_system(B, N, dev)
    B, S, nz, _ = K.shape
    gen = torch.Generator(dev).manual_seed(1)
    E = 0.3 * torch.randn((B, S - 1, nz, nz), device=dev,
                          generator=gen) / nz ** 0.5
    Kd = (K + torch.diag_embed(reg)[:, None]).contiguous()
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    Sd, W = bd.factor_dense(Kd, E)
    yd = bd.fwd_dense(Sd, E, r)
    calls = {
        "factor_se": lambda: bk.factor_se(K, ev, reg, pat),
        "fwd_se": lambda: bk.fwd_se(Sinv, ev, r, pat),
        "bwd_matvec_se": lambda: bk.bwd_matvec_se(Wc, y, K, ev, pat),
        "bwd_se": lambda: bk.bwd_se(Wc, y, pat),
        "factor_dense": lambda: bd.factor_dense(Kd, E),
        "fwd_dense": lambda: bd.fwd_dense(Sd, E, r),
        "bwd_dense": lambda: bd.bwd_dense(W, yd),
    }
    torch.cuda.synchronize()
    return {name: kb.device_ms(fn, runs)[0] for name, fn in calls.items()}


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import obca_torch
    from obca_torch.tools import kernel_bench as kb

    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device is available")
    if not os.path.abspath(obca_torch.__file__).startswith(root + os.sep):
        sys.exit(f"kernel_times: obca_torch came from {obca_torch.__file__}, "
                 f"not from {root}")
    print(json.dumps({"card": kb.card(), "root": root,
                      "device_ms": measure(args.runs)}))


if __name__ == "__main__":
    main()
