"""obca_torch's debug step and ``ipm.debug_iterate`` against obca_tpu's.

``reverse_parking_spec(N=10, Ts=1.6)`` from the port's lattice warm
start (the same W0 to both), ``SolverConfig(max_iter=50)``, float64 on
the CPU.  The two packages' linear solves differ (the port's factor
pivots, the JAX package's does not) and each leaves a residual, so the
directions agree only as far as the KKT systems' conditioning allows;
at Ts=1.6 the 6 steps agree well within the tolerance below, at Ts=1.2
one group maximum of the first direction already does not.

* the diagnostics of ``_make_step(..., debug=True)`` against the JAX
  package's for the first 6 iterations: the same keys, the flags equal,
  every value within 1e-6 relative (1e-6 absolute below 1: maxima of
  residuals, steps and step lengths whose last digits are rounding).
  ``linres``, the residual the linear solve leaves, measures the two
  packages' factorizations rather than the iterate, and is held to 1e-5
  absolute;
* ``debug_iterate``'s printed lines: JAX's lines with the numbers taken
  out, and its flags;
* ``debug=False`` leaves the step as it was: its states are bit for bit
  the debug step's, and a solve is bit for bit the loop of its steps.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import spec as tspec
from obca_torch.convert import config_from_numpy, spec_from_numpy
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import SolverConfig as JSolverConfig
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

N_STEPS = 6
RTOL = 1e-6
LINRES_ATOL = 1e-5


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


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def case():
    """(JAX spec, port spec, JAX config, port config, W0, JAX diags of
    the first N_STEPS debug steps)."""
    jspec = j_reverse_parking_spec(N=10, Ts=1.6)
    jcfg = JSolverConfig(max_iter=50)
    spec = spec_from_numpy(_to_numpy_tree(jspec), device="cpu")
    W0 = geometric.lattice_warm_start(tspec.stack([spec]))[0].numpy()
    state, step, _, _ = jipm._make_step(jspec, jcfg, jnp.asarray(W0), None,
                                        debug=True)
    jstep = jax.jit(step)
    diags = []
    for _ in range(N_STEPS):
        state, d = jstep(state)
        diags.append(dict(_flat(jax.tree.map(np.asarray, d))))
    return (jspec, spec, jcfg, config_from_numpy(_to_numpy_tree(jcfg)), W0,
            diags)


def _port_steps(spec, cfg, W0, debug):
    with torch.no_grad():
        state, step, _, _ = ipm._make_step(
            tspec.stack([spec]), cfg, torch.tensor(W0)[None], debug=debug)
        out = []
        for _ in range(N_STEPS):
            res = step(state)
            state, d = res if debug else (res, None)
            out.append((state, d))
    return out


def test_debug_diagnostics_match_jax(case):
    _, spec, _, cfg, W0, jdiags = case
    for i, (_, d) in enumerate(_port_steps(spec, cfg, W0, debug=True)):
        got = dict(_flat(d))
        want = jdiags[i]
        assert set(got) == set(want), set(got) ^ set(want)
        for k, v in got.items():
            a, b = v[0].item(), want[k].item()
            if isinstance(b, bool):
                assert a == b, (i, k, a, b)
            elif k == "linres":
                assert abs(a - b) <= LINRES_ATOL, (i, k, a, b)
            else:
                assert abs(a - b) <= RTOL * max(abs(b), 1.0), (i, k, a, b)


def _shape(line):
    """A printed line with its numbers taken out."""
    return re.sub(r"-?\d+(\.\d+)?(e[+-]\d+)?", "#", line)


def test_debug_iterate_prints_jax_lines(case):
    jspec, spec, jcfg, cfg, W0, _ = case
    jlines, tlines = [], []
    jipm.debug_iterate(jspec, jcfg, jnp.asarray(W0), n_iter=N_STEPS,
                       printer=jlines.append)
    state = ipm.debug_iterate(spec, cfg, torch.tensor(W0), n_iter=N_STEPS,
                              printer=tlines.append)
    assert len(tlines) == len(jlines) == 2 * N_STEPS
    for t_line, j_line in zip(tlines, jlines):
        assert _shape(t_line) == _shape(j_line), (t_line, j_line)
        flags = re.findall(r"(?:found|fin)=\w+|full=\d|soc=\d", t_line)
        assert flags == re.findall(r"(?:found|fin)=\w+|full=\d|soc=\d",
                                   j_line)
    assert state.W.shape == W0.shape and int(state.iters) == N_STEPS


def test_debug_false_step_unchanged(case):
    """The debug branch only reads the step's values."""
    _, spec, _, cfg, W0, _ = case
    plain = _port_steps(spec, cfg, W0, debug=False)
    dbg = _port_steps(spec, cfg, W0, debug=True)
    for (s_p, _), (s_d, _) in zip(plain, dbg):
        for a, b in zip(s_p, s_d):
            assert torch.equal(a, b)
    # solve_batch is the loop of the debug=False step (no lane converges
    # within N_STEPS, so every step is taken whole).
    cfg_n = dataclasses.replace(cfg, max_iter=N_STEPS)
    res = ipm.solve_batch(tspec.stack([spec]), cfg_n, torch.tensor(W0)[None])
    assert int(res.iters[0]) == N_STEPS
    assert torch.equal(res.W, plain[-1][0].W)


def test_debug_step_nav_groups():
    """With ``prob=nav`` the diagnostics split nav's constraint groups
    (no OBCA equality rows) and the state is the plain step's."""
    from obca_torch import SolverConfig, nav

    spec = tspec.stack([nav.nav_spec(N=10, device="cpu")])
    outs = []
    with torch.no_grad():
        for debug in (False, True):
            state, step, _, _ = ipm._make_step(spec, SolverConfig(), None,
                                               prob=nav, debug=debug)
            outs.append(step(state))
    (plain, (state, diag)) = outs
    assert set(diag["dnu_g"]) == {"bc", "dyn", "tau", "nrm", "dst", "rate"}
    for a, b in zip(plain, state):
        assert torch.equal(a, b)
