"""obca_torch's float64 solve at the main path's horizon (N=80): from
the golden warm start of ``oracle/goldens/reverse_parking_N80.npz`` it
reaches the JAX package's float64 optimum — controls within 1e-6,
objective to rtol 1e-8."""

import pathlib

import numpy as np
import torch

from obca_torch import SolverConfig, reverse_parking_spec
from obca_torch.solver import ipm

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "oracle" / "goldens"
          / "reverse_parking_N80.npz")


def test_solve_single_f64_reaches_golden_n80():
    gold = np.load(GOLDEN)
    spec = reverse_parking_spec(N=int(gold["N"]), Ts=float(gold["Ts"]),
                                device="cpu")
    res = ipm.solve_single(spec, SolverConfig(max_iter=300),
                           torch.tensor(gold["W0"]))
    assert int(res.status) == ipm.STATUS_CONVERGED
    np.testing.assert_allclose(res.U.numpy(), gold["U"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res.obj), float(gold["obj"]),
                               rtol=1e-8)
