"""obca_torch's interior-point solver at N=40 on the CPU.

* float64 ``solve_single`` from the golden warm start reaches the
  golden optimum of ``oracle/goldens/reverse_parking_N40.npz`` (the
  JAX package's float64 solve): controls within 1e-6, objective to
  rtol 1e-8;
* the float32 configuration the H100 runs (``f32_solver_config``)
  converges every lane of a three-lane ``solve_batch_rescued`` batch
  from lattice warm starts, with the unshifted lane within 1e-3 of the
  golden controls.
"""

import dataclasses
import pathlib

import numpy as np
import torch

from obca_torch import (SolverConfig, f32_solver_config,
                        reverse_parking_spec)
from obca_torch import spec as tspec
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric, lattice

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).resolve().parents[1] / "oracle" / "goldens"


def test_solve_single_f64_reaches_golden_n40():
    gold = np.load(GOLDENS / "reverse_parking_N40.npz")
    spec = reverse_parking_spec(N=40, Ts=0.6, device="cpu")
    res = ipm.solve_single(spec, SolverConfig(max_iter=300),
                           torch.tensor(gold["W0"]))
    assert int(res.status) == ipm.STATUS_CONVERGED
    np.testing.assert_allclose(res.U.numpy(), gold["U"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res.obj), float(gold["obj"]),
                               rtol=1e-8)


def test_f32_rescued_batch_converges_near_golden():
    gold = np.load(GOLDENS / "reverse_parking_N40.npz")
    base = reverse_parking_spec(N=40, Ts=0.6, device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(base)
    field = lattice.plan_field(base, lcfg)
    shifts = [-0.1, 0.0, 0.1]
    specs = tspec.stack([
        dataclasses.replace(base, x0=base.x0 + torch.tensor(
            [s, 0.0, 0.0, 0.0], dtype=torch.float64)) for s in shifts])
    W0 = geometric.lattice_warm_start(specs, dtype=torch.float32, cfg=lcfg,
                                      field=field)
    res = ipm.solve_batch_rescued(specs, f32_solver_config(), W0)
    assert res.W.dtype == torch.float32
    assert np.all(res.status.numpy() == ipm.STATUS_CONVERGED)
    gap = np.abs(res.U[1].double().numpy() - gold["U"]).max()
    assert gap < 1e-3, gap


def test_rescue_reseeds_a_starved_lane():
    """A lane whose warm start is poisoned (zero inputs and duals) and
    whose pass 1 is cut short is re-solved from its converged
    neighbours; the rescue never loses a lane pass 1 had, keeps the
    converged lanes' results, and counts both passes' iterations."""
    base = reverse_parking_spec(N=40, Ts=0.6, device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(base)
    field = lattice.plan_field(base, lcfg)
    specs = tspec.stack([
        dataclasses.replace(base, x0=base.x0 + torch.tensor(
            [s, 0.0, 0.0, 0.0], dtype=torch.float64))
        for s in (-0.05, 0.0, 0.05)])
    W0 = geometric.lattice_warm_start(specs, cfg=lcfg, field=field)
    W0[1, :, 4:] = 0.0
    # At this cap pass 1 converges lane 0 (37 iterations) and not lane 2
    # (54) or the poisoned lane 1, which fails at any cap.
    cfg = SolverConfig(max_iter=45)
    res1 = ipm.solve_batch(specs, cfg, W0)
    res = ipm.solve_batch_rescued(specs, cfg, W0)
    ok1 = res1.status.numpy() == ipm.STATUS_CONVERGED
    ok = res.status.numpy() == ipm.STATUS_CONVERGED
    assert ok1.any() and not ok1.all()
    assert np.all(ok[ok1])
    assert torch.equal(res.W[ok1], res1.W[ok1])
    rescued = ~ok1 & ok
    assert rescued.any()
    assert np.all(res.iters.numpy()[rescued] > res1.iters.numpy()[rescued])
