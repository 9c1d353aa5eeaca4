"""Full-size batches and systems of the port's paths, as the JAX
package's benchmark scripts build them, with the solver settings those
scripts use.

The card tests (``tests/test_torch_cuda.py``,
``tests/test_torch_card_paths.py``) and ``chip_smoke.py`` run them at
these sizes; ``first_periods`` of ``tests/test_torch_mpc.py`` cuts the
MPC fleet to a few lanes on the CPU.  Each function takes the device;
none runs at import.  This module imports nothing of JAX and nothing of
``obca_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# bench.py's main path: B start-pose shifts of reverse parking, N=80.
B_MAIN, N_MAIN, TS_MAIN, ITERS_MAIN = 128, 80, 0.3, 55
# bench/run_sweep.py's f32 caps: the topology-varied reverse family and
# the parallel family (B = 32).
ITERS_RANDOM = 70
B_PARALLEL, ITERS_PARALLEL = 32, 250
# bench/run_mpc.py's defaults (fleet, f32) and its re-solve knobs.
B_MPC, MPC_SPREAD, ITERS_MPC = 128, 0.3, 70
RESOLVE_MU, RESOLVE_ITERS, RESOLVE_TOL = 1e-4, 60, 1e-3
# The nav batch on tests/test_nav.py's grazing layout.
NAV_VERTS = [
    [(-4.0, 0.5), (-2.0, 0.5), (-2.0, 5.0), (-4.0, 5.0)],
    [(2.0, -5.0), (4.0, -5.0), (4.0, -0.5), (2.0, -0.5)],
]
B_NAV, N_NAV, NAV_SPREAD, ITERS_NAV = 128, 60, 0.4, 150


def main_path_batch(device, dtype=torch.float32, B=B_MAIN):
    """bench.py's batch: B start-pose shifts of the canonical reverse
    parking scenario in ``dtype`` (float64 is ``BENCH_DTYPE=mixed``).
    The shifts are float32 draws, as there.  Returns (base spec, stacked
    specs)."""
    from obca_torch import reverse_parking_spec
    from obca_torch import spec as tspec

    base = reverse_parking_spec(N=N_MAIN, Ts=TS_MAIN, dtype=dtype,
                                device=device)
    shifts = np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(B, 2)).astype(np.float32)
    specs = tspec.stack([
        dataclasses.replace(base, x0=base.x0 + torch.tensor(
            [dx, dy, 0.0, 0.0], dtype=dtype, device=device))
        for dx, dy in shifts])
    return base, specs


def main_path_start(base, specs):
    """(config, W0) of bench.py's solve of a :func:`main_path_batch`: the
    f32 route for float32 specs and the mixed route for float64 ones,
    cap ITERS_MAIN; one shared ``plan_field`` and per-lane
    ``lattice_warm_start``.  bench.py then calls
    ``ipm.solve_batch_rescued(specs, config, W0, rescue_mu=1e-5)``."""
    from obca_torch import f32_solver_config, mixed_solver_config
    from obca_torch.warmstart import geometric, lattice

    dtype = specs.x0.dtype
    cfg = (f32_solver_config if dtype == torch.float32
           else mixed_solver_config)(max_iter=ITERS_MAIN)
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(specs, dtype=dtype, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    return cfg, W0


def random_family_batch(device, family, B, n_layouts):
    """``bench/run_sweep.py``'s shard in float32 (seed 0, N=80, Ts=0.3):
    a randomized batch of ``family`` ("reverse": topology-varied;
    "parallel": its default, topology-varied too) and the static lattice
    grid of the family's base spec padded to 4 obstacles of 5 faces.
    Returns (specs, layouts, lattice config)."""
    import obca_torch as ot
    from obca_torch.warmstart import lattice

    kw = dict(N=N_MAIN, Ts=TS_MAIN, dtype=torch.float32, device=device)
    if family == "reverse":
        specs, layouts, _ = ot.randomized_reverse_parking_specs(
            B, n_layouts=n_layouts, seed=0, vary_topology=True, **kw)
        base = ot.reverse_parking_spec(max_obs=4, max_faces=5, **kw)
    else:
        specs, layouts, _ = ot.randomized_parallel_parking_specs(
            B, n_layouts=n_layouts, seed=0, **kw)
        base = ot.parallel_parking_spec(max_obs=4, max_faces=5, **kw)
    return specs, layouts, lattice.LatticeConfig.for_spec(base)


def mpc_fleet_batch(device, B=B_MPC, seed=0):
    """``bench/run_mpc.py``'s fleet: B starts of
    ``reverse_parking_spec(N=80, Ts=0.3)`` in float32, each start's x, y
    shifted by float32 draws of ``np.random.default_rng(seed).uniform(
    -MPC_SPREAD, MPC_SPREAD, (B, 2))`` (``bench/_common.py``'s
    ``scenario_batch``).  Returns (base spec, stacked specs)."""
    from obca_torch import reverse_parking_spec
    from obca_torch import spec as tspec

    base = reverse_parking_spec(N=N_MAIN, Ts=24.0 / N_MAIN,
                                dtype=torch.float32, device=device)
    x0 = np.tile(base.x0.cpu().numpy(), (B, 1))
    x0[:, :2] += np.random.default_rng(seed).uniform(
        -MPC_SPREAD, MPC_SPREAD, size=(B, 2)).astype(x0.dtype)
    specs = dataclasses.replace(tspec.stack([base] * B),
                                x0=torch.as_tensor(x0, device=device))
    return base, specs


def nav_batch(device):
    """B_NAV lanes of ``nav.nav_spec()`` (N=60, Ts=0.25, 4 obstacles of
    4 faces: nz = 44) in float64 on the grazing layout of
    ``tests/test_nav.py``, lane b's start y shifted by
    ``np.random.default_rng(0).uniform(-NAV_SPREAD, NAV_SPREAD,
    B_NAV)[b]``.  Returns (base spec, stacked specs)."""
    from obca_torch import nav
    from obca_torch import spec as tspec

    base = nav.nav_spec(N=N_NAV, vertex_lists=NAV_VERTS, device=device)
    x0 = np.tile(base.x0.cpu().numpy(), (B_NAV, 1))
    x0[:, 1] += np.random.default_rng(0).uniform(-NAV_SPREAD, NAV_SPREAD,
                                                 B_NAV)
    specs = dataclasses.replace(tspec.stack([base] * B_NAV),
                                x0=torch.as_tensor(x0, device=device))
    return base, specs


def qd_blocks(rng, B, S, nw, nc):
    """Random quasidefinite stage blocks [[A, J'], [J, D]] with A = M M'
    / nw + 2 I and D = -(Q Q' / nc + I), and their regularization +-1e-4,
    numpy f64: (K [B, S, nz, nz], reg [B, nz])."""
    M = rng.standard_normal((B, S, nw, nw))
    A = M @ np.swapaxes(M, -1, -2) / nw + 2.0 * np.eye(nw)
    Q = rng.standard_normal((B, S, nc, nc))
    D = -(Q @ np.swapaxes(Q, -1, -2) / nc + np.eye(nc))
    J = rng.standard_normal((B, S, nc, nw))
    K = np.concatenate([np.concatenate([A, np.swapaxes(J, -1, -2)], -1),
                        np.concatenate([J, D], -1)], -2)
    reg = np.tile(np.concatenate([np.full(nw, 1e-4), np.full(nc, -1e-4)]),
                  (B, 1))
    return K, reg


def full_size_system(case):
    """A system at the main paths' shape, B=128, S=81, numpy f64: (K, ev,
    reg, r, pattern, E).  Quasidefinite stage blocks (:func:`qd_blocks`)
    on the layout and coupling pattern of ``reverse_parking_spec(N=80)``
    (nw 31, nc 25: nz = 56; seeds 0 and 1) or of that spec padded to 4
    obstacles of 5 faces, the randomized families' layout (nz = 72;
    seeds 3 and 4); coupling values 0.3 N(0, 1); E a genuinely dense
    coupling block per stage, 0.3 N(0, 1) / sqrt(nz).  At nz = 72,
    "permuted" permutes every block's rows (seed 2) and "tiny_lead" sets
    its regularized leading diagonal entry to 1e-8: both need row
    interchanges."""
    from obca_torch import nlp, reverse_parking_spec
    from obca_torch.solver.kernels import blocktri_se as bk

    B, S = 128, 81
    width, _, kind = case.partition("_")
    wide = width == "nz72"
    L = nlp.layout_of(reverse_parking_spec(
        N=80, Ts=0.3, device="cpu",
        **(dict(max_obs=4, max_faces=5) if wide else {})))
    rows, cols = nlp.coupling_structure(L)
    seed = 3 if wide else 0
    rng = np.random.default_rng(seed)
    K, reg = qd_blocks(rng, B, S, L.nw, L.nc)
    ev = 0.3 * rng.standard_normal((B, S - 1, len(rows)))
    r = rng.standard_normal((B, S, L.nz))
    E = 0.3 * np.random.default_rng(seed + 1).standard_normal(
        (B, S - 1, L.nz, L.nz)) / np.sqrt(L.nz)
    if kind == "tiny_lead":
        K[:, :, 0, 0] = 1e-8 - reg[:, None, 0]
    elif kind == "permuted":
        perm = np.argsort(np.random.default_rng(2).random(K.shape[:3]), -1)
        K = np.take_along_axis(K, perm[..., None], axis=2)
    return K, ev, reg, r, bk.CouplingPattern.of(rows, cols), E
