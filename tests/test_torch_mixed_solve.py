"""obca_torch's mixed-precision solve (f64 iterate, f32 factor) end to
end on the CPU, against the float64 golden and against obca_tpu.

The distance-variant reverse-parking instance at N=40
(``oracle/goldens/reverse_parking_dist_N40.npz``) is solved from the
golden's warm start under ``mixed_solver_config(max_iter=200)`` — the
configuration of ``tests/test_parity_fastpath.py``'s distance-family
parity test — by the port's ``ipm.solve_single`` and by the JAX
package's, jitted as that test jits it.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from obca_torch import mixed_solver_config, reverse_parking_spec
from obca_torch.solver import ipm
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import mixed_solver_config as j_mixed_solver_config
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).resolve().parents[1] / "oracle" / "goldens"


def test_mixed_solve_single_reaches_golden_and_matches_jax():
    """(e) Converged; controls within 1e-5 of the golden's; and within
    1e-6 of the JAX package's mixed solve.  Both factor in f32 and
    refine in f64 to the same KKT point, but the f32 factors differ (the
    port pivots, the JAX XLA route inverts pivot-free, primal block
    first), so the iterates take different paths: measured 66 port
    iterations against 53, with controls 3.0e-11 (port) and 5.2e-9 (JAX)
    from the golden's and 5.2e-9 from each other."""
    gold = np.load(GOLDENS / "reverse_parking_dist_N40.npz")
    N, Ts = int(gold["N"]), float(gold["Ts"])

    spec = reverse_parking_spec(N=N, Ts=Ts, signed=False, device="cpu")
    res = ipm.solve_single(spec, mixed_solver_config(max_iter=200),
                           torch.tensor(gold["W0"]))
    assert res.W.dtype == torch.float64
    assert int(res.status) == ipm.STATUS_CONVERGED
    U = res.U.numpy()
    np.testing.assert_allclose(U, gold["U"], rtol=0, atol=1e-5)

    jspec = j_reverse_parking_spec(N=N, Ts=Ts, signed=False)
    jcfg = j_mixed_solver_config(max_iter=200)
    W0 = jnp.asarray(gold["W0"])
    jres = jax.jit(lambda sp: jipm.solve_single(sp, jcfg, W0))(jspec)
    assert int(jres.status) == jipm.STATUS_CONVERGED
    np.testing.assert_allclose(U, np.asarray(jres.U), rtol=0, atol=1e-6)
