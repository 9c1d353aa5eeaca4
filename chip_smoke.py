"""The port's on-card check: every card test, then the kernels line.

    python chip_smoke.py

Runs the card tests (marker ``gpu``) of ``tests/test_torch_cuda.py`` and
``tests/test_torch_card_paths.py`` through pytest, and exits with
pytest's status if one fails.  Then prints one ``kernels`` JSON line:
for each of the seven solver kernels, its launches in one counted run
of the f32 main path (``tests/full_size_batches.py``: B=128, N=80), and
its device time per call (``kernel_bench.device_ms``) and least time
(``kernel_bench.bound_ms``) on the full-size systems at nz = 56 and 72
(``full_size_batches.full_size_system``); then the device line, last.
It imports nothing of JAX and nothing of ``obca_tpu``.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD_TESTS = ("tests/test_torch_cuda.py", "tests/test_torch_card_paths.py")
WIDTHS = ("nz56", "nz72")


def kernel_calls(case, device):
    """({kernel: one call of it} on ``full_size_system(case)`` in float32,
    each fed the outputs of the kernel before it; the system's (B, S,
    nz, nnz, C) for ``kernel_bench.kernel_costs``)."""
    import torch

    import full_size_batches as fsb
    from obca_torch.solver.kernels import blocktri_dense as bd
    from obca_torch.solver.kernels import blocktri_se as bk

    *arrays, pat, E = fsb.full_size_system(case)
    K, ev, reg, r, E = (torch.as_tensor(a, dtype=torch.float32,
                                        device=device).contiguous()
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
    for case in WIDTHS:
        calls, shape = kernel_calls(case, device)
        costs = kb.kernel_costs(*shape)
        for name, fn in calls.items():
            ms, by = kb.bound_ms(*costs[name])
            kernels.setdefault(name, {"name": name,
                                      "launches": launches[name]})
            kernels[name][case] = {"device_ms": kb.device_ms(fn)[0],
                                   "bound_ms": ms, "bound_by": by}
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "card": kb.card(), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
