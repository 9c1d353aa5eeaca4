"""obca_torch's batched solve with rescue against obca_tpu's, live.

Both packages solve the same three reverse-parking lanes (N=40, start
shifted by -0.1 / 0 / +0.1 m in x) from the same lattice warm starts
with ``solve_batch_rescued`` under ``SolverConfig(max_iter=200)``, in
float64 on the CPU — the batch ``tests/test_rescue.py`` uses.  The JAX
specs and config are flattened to numpy and rebuilt for the port with
``obca_torch.convert``; the port's warm starts go to both.  The
statuses must agree and the controls within 1e-6.
One rescue round instead of the default two: every lane converges in
pass 1 here, so the rounds are skipped at run time on both sides, and
each round costs the JAX side about 15 s of tracing and compiling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from obca_torch.convert import config_from_numpy, spec_from_numpy
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric, lattice
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import SolverConfig as JSolverConfig
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

SHIFTS = [-0.1, 0.0, 0.1]


def _to_numpy_tree(obj):
    """A JAX dataclass as a dict of numpy leaves (everything else as
    is)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_numpy_tree(v)
        elif isinstance(v, jax.Array):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def test_solve_batch_rescued_matches_jax():
    jbase = j_reverse_parking_spec(N=40, Ts=0.6)
    jspecs = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[dataclasses.replace(jbase, x0=jbase.x0.at[0].add(float(s)))
          for s in SHIFTS])
    cfg = JSolverConfig(max_iter=200)

    base = spec_from_numpy(_to_numpy_tree(jbase), device="cpu")
    specs = spec_from_numpy(_to_numpy_tree(jspecs), device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(base)
    field = lattice.plan_field(base, lcfg)
    W0 = geometric.lattice_warm_start(specs, cfg=lcfg, field=field)
    res = ipm.solve_batch_rescued(specs,
                                  config_from_numpy(_to_numpy_tree(cfg)), W0,
                                  rescue_rounds=1)

    jres = jax.jit(lambda sp, w: jipm.solve_batch_rescued(
        sp, cfg, w, rescue_rounds=1))(jspecs, jnp.asarray(W0.numpy()))

    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    assert np.all(res.status.numpy() == ipm.STATUS_CONVERGED)
    np.testing.assert_allclose(res.U.numpy(), np.asarray(jres.U), rtol=0,
                               atol=1e-6)
