"""obca_torch's randomized-obstacle families against obca_tpu.

* the two generators give the JAX package's specs bit for bit in
  float64 (and the same float32 specs), with and without topology
  variation: the same ``np.random.default_rng(seed)`` draws in the same
  order, rejection sampling included;
* ``grouped_lattice_warm_start`` (one plan field per layout, each
  group's lanes extracted from it) against the JAX package's, for both
  families; the parallel layouts carry their own ``xy_lo``, while the
  static grid comes from the base spec, as ``bench/run_sweep.py`` builds
  it;
* ``rs_warm_start`` against the JAX package's at N=20 and N=40;
* the slice end to end: a topology-varied reverse batch (B=4, two
  layouts, seed 3), its grouped warm start and the batched solve, in
  float64 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import SolverConfig
from obca_torch import spec as tspec
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric, lattice
from obca_tpu import spec as jspec
from obca_tpu.solver import ipm as jipm
from obca_tpu.warmstart import geometric as jgeometric
from obca_tpu.warmstart import lattice as jlattice

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

N, TS = 20, 1.2
# Batch of the grouped warm start and of the end-to-end slice.
BATCH = dict(B=4, n_layouts=2, seed=3, N=N, Ts=TS, pose_spread=0.3,
             vary_topology=True)


def _leaves(obj, prefix=""):
    """{dotted field name: numpy array or static value} of a spec
    dataclass of either package."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        elif isinstance(v, (torch.Tensor, jax.Array)):
            out[prefix + f.name] = np.asarray(v)
        else:
            out[prefix + f.name] = v
    return out


def _generators(family):
    return (getattr(tspec, f"randomized_{family}_parking_specs"),
            getattr(jspec, f"randomized_{family}_parking_specs"))


@pytest.mark.parametrize("family,vary,dtype", [
    ("reverse", False, "float64"), ("reverse", True, "float64"),
    ("parallel", False, "float64"), ("parallel", True, "float64"),
    ("reverse", True, "float32"), ("parallel", True, "float32")])
def test_generators_match_jax(family, vary, dtype):
    """Every leaf of the specs and the layouts equal to the JAX
    package's, exactly, and the same group size; 8 lanes over 4 layouts
    at N=20, Ts=1.2."""
    gen, jgen = _generators(family)
    kw = dict(B=8, n_layouts=4, seed=3, N=N, Ts=TS, vary_topology=vary)
    specs, layouts, group = gen(**kw, dtype=getattr(torch, dtype),
                                device="cpu")
    jspecs, jlayouts, jgroup = jgen(**kw, dtype=getattr(jnp, dtype))
    assert group == jgroup == 2
    for got, want in ((specs, jspecs), (layouts, jlayouts)):
        a, b = _leaves(got), _leaves(want)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    if vary:
        assert specs.obstacles.A.shape[1:] == (4, 5, 2)


@pytest.fixture(scope="module")
def reverse_batch():
    """The topology-varied reverse batch on both sides, the static grid
    of its base spec, and the port's grouped warm start."""
    specs, layouts, _ = tspec.randomized_reverse_parking_specs(
        **BATCH, device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(tspec.reverse_parking_spec(
        N=N, Ts=TS, max_obs=4, max_faces=5, device="cpu"))
    W0 = geometric.grouped_lattice_warm_start(specs, layouts, lcfg)
    jspecs, jlayouts, _ = jspec.randomized_reverse_parking_specs(**BATCH)
    return specs, layouts, lcfg, W0, jspecs, jlayouts


@pytest.mark.parametrize("family", ["reverse", "parallel"])
def test_grouped_lattice_warm_start_matches_jax(family, reverse_batch):
    """The port's grouped warm start within 1e-10 of the JAX package's
    (float64; the lattice's integer decisions agree, the rest is
    rounding), the static grid from the base spec for both."""
    base_kw = dict(N=N, Ts=TS, max_obs=4, max_faces=5)
    if family == "reverse":
        specs, layouts, lcfg, W0, jspecs, jlayouts = reverse_batch
        jbase = jspec.reverse_parking_spec(**base_kw)
    else:
        gen, jgen = _generators(family)
        specs, layouts, _ = gen(**BATCH, device="cpu")
        lcfg = lattice.LatticeConfig.for_spec(
            tspec.parallel_parking_spec(**base_kw, device="cpu"))
        W0 = geometric.grouped_lattice_warm_start(specs, layouts, lcfg)
        jspecs, jlayouts, _ = jgen(**BATCH)
        jbase = jspec.parallel_parking_spec(**base_kw)
        # The layouts' own state boxes differ from the static grid's.
        assert not np.array_equal(layouts.xy_lo[:, 1].numpy(),
                                  np.full(2, lcfg.grid_lo[1]))
    jlcfg = jlattice.LatticeConfig.for_spec(jbase)
    assert dataclasses.asdict(jlcfg) == dataclasses.asdict(lcfg)
    jW0 = jax.jit(lambda s, l: jgeometric.grouped_lattice_warm_start(
        s, l, jlcfg))(jspecs, jlayouts)
    assert W0.shape == jW0.shape
    np.testing.assert_allclose(W0.numpy(), np.asarray(jW0), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("n,ts", [(20, 1.2), (40, 0.6)])
def test_rs_warm_start_matches_jax(n, ts):
    """The Reeds-Shepp warm start (path, velocity profile, geometric
    duals) within 1e-10 of the JAX package's, single and batched."""
    spec = tspec.reverse_parking_spec(N=n, Ts=ts, device="cpu")
    W = geometric.rs_warm_start(spec)
    jW = jax.jit(jgeometric.rs_warm_start)(jspec.reverse_parking_spec(
        N=n, Ts=ts))
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=0,
                               atol=1e-10)
    Wb = geometric.rs_warm_start(tspec.stack([spec, spec]))
    np.testing.assert_array_equal(Wb[1].numpy(), W.numpy())


def test_randomized_slice_matches_jax(reverse_batch):
    """Grouped warm start, then ``solve_batch_rescued`` under
    ``SolverConfig()`` in float64, against the JAX package's
    ``solve_batch`` from the same warm start: equal statuses (all
    converged, so no rescue round runs on the port's side), equal
    iteration counts and controls within 1e-6."""
    specs, _, _, W0, jspecs, _ = reverse_batch
    res = ipm.solve_batch_rescued(specs, SolverConfig(), W0)
    jres = jax.jit(lambda s, w: jipm.solve_batch(s, jspec.SolverConfig(),
                                                 w))(
        jspecs, jnp.asarray(W0.numpy()))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert np.all(res.status.numpy() == ipm.STATUS_CONVERGED)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_allclose(res.U.numpy(), np.asarray(jres.U), rtol=0,
                               atol=1e-6)
