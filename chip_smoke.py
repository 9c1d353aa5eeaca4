"""The port's on-card check: every card test, then the kernels line.

    python chip_smoke.py

Runs the card tests (marker ``gpu``) of ``tests/test_torch_cuda.py`` and
``tests/test_torch_card_paths.py`` through pytest, and exits with
pytest's status if one fails.  Then prints one ``kernels`` JSON line:
for each of the seven solver kernels and ``ruiz_se``, its launches in
one counted run of the f32 main path (``tests/full_size_batches.py``:
B=128, N=80), and its device time per call (``kernel_bench.device_ms``)
and least time (``kernel_bench.bound_ms``) on the full-size systems at
nz = 56 and 72 (``full_size_batches.full_size_system``) and at nz = 56
with the lanes repeated to B=1024 (``ruiz_se`` also its plain version's
device time); then the device line, last.
It imports nothing of JAX and nothing of ``obca_tpu``.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD_TESTS = ("tests/test_torch_cuda.py", "tests/test_torch_card_paths.py")
# (name, full_size_system's case, lanes repeated): B=128 at nz = 56 and
# 72, and B=1024 at nz = 56.
CASES = (("nz56", "nz56", 1), ("nz72", "nz72", 1),
         ("nz56_b1024", "nz56", 8))


def kernel_calls(case, device, copies=1):
    """({kernel: one call of it} on ``full_size_system(case)`` in float32,
    its lanes repeated ``copies`` times, each kernel fed the outputs of
    the kernel before it; ``ruiz_se`` with ``f32_solver_config``'s 3
    sweeps, and its plain version as ``ruiz_se_plain``; the system's (B,
    S, nz, nnz, C) for ``kernel_bench.kernel_costs``)."""
    import torch

    import full_size_batches as fsb
    from obca_torch.solver.kernels import blocktri_dense as bd
    from obca_torch.solver.kernels import blocktri_se as bk

    *arrays, pat, E = fsb.full_size_system(case)
    K, ev, reg, r, E = (torch.as_tensor(a, dtype=torch.float32,
                                        device=device)
                        .repeat(copies, *(1,) * (a.ndim - 1)).contiguous()
                        for a in (*arrays, E))
    Kd = (K + torch.diag_embed(reg)[:, None]).contiguous()
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    Sd, W = bd.factor_dense(Kd, E)
    yd = bd.fwd_dense(Sd, E, r)
    B, S, nz, _ = K.shape
    return {
        "factor_se": lambda: bk.factor_se(K, ev, reg, pat),
        "fwd_se": lambda: bk.fwd_se(Sinv, ev, r, pat),
        "bwd_matvec_se": lambda: bk.bwd_matvec_se(Wc, y, K, ev, pat),
        "bwd_se": lambda: bk.bwd_se(Wc, y, pat),
        "factor_dense": lambda: bd.factor_dense(Kd, E),
        "fwd_dense": lambda: bd.fwd_dense(Sd, E, r),
        "bwd_dense": lambda: bd.bwd_dense(W, yd),
        "ruiz_se": lambda: bk.ruiz_se(K, ev, r, pat, 3),
        "ruiz_se_plain": lambda: bk.ruiz_se_plain(K, ev, r, pat, 3),
    }, (B, S, nz, ev.shape[-1], len(pat.ucols))


def main():
    import pytest
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    rc = pytest.main(["--noconftest", "-q", "-m", "gpu", "-p",
                      "no:cacheprovider",
                      *(os.path.join(ROOT, f) for f in CARD_TESTS)])
    if rc != 0:
        sys.exit(int(rc))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import full_size_batches as fsb
    from obca_torch.solver import ipm
    from obca_torch.solver.kernels import blocktri_se as bk
    from obca_torch.tools import kernel_bench as kb

    device = torch.device("cuda", 0)
    base, specs = fsb.main_path_batch(device)
    cfg, W0 = fsb.main_path_start(base, specs)
    bk.reset_launches()
    ipm.solve_batch_rescued(specs, cfg, W0, rescue_mu=1e-5)
    torch.cuda.synchronize()
    launches = dict(bk.launches)
    kernels = {}
    for label, case, copies in CASES:
        calls, shape = kernel_calls(case, device, copies)
        costs = kb.kernel_costs(*shape)
        for name, fn in calls.items():
            kernel = name.removesuffix("_plain")
            ms, by = kb.bound_ms(*costs[kernel])
            kernels.setdefault(kernel, {"name": kernel,
                                        "launches": launches[kernel]})
            entry = kernels[kernel].setdefault(
                label, {"bound_ms": ms, "bound_by": by})
            key = "device_ms" if name == kernel else "plain_ms"
            entry[key] = kb.device_ms(fn)[0]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "card": kb.card(), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
