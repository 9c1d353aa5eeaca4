"""The IPM loop turn that ``obca_torch.solver.ipm`` replays as CUDA
graphs on a CUDA batch, checked on the CPU at N=20, B=4.

* capturability: one turn (the step's generator with the running-lane
  merge and write-back of ``ipm._graph_turn``), parking on the f32 route
  and nav on the mixed route, issues no operation that reads a device
  value back (``_local_scalar_dense``, ``nonzero``, ...) and builds no
  tensor from Python or numpy data (``torch.tensor``, ``as_tensor``,
  ``from_numpy``, a list or array lifted into a tensor, as an index
  array is, and an advanced-index assignment of a Python scalar, which
  the card copies from the host): on the card each of these fails or
  breaks a graph's capture.  The factor kernel's
  wrapper runs between the segments, outside the check, once a turn
  (parking, SOC off) or twice (nav, SOC on).
* bit for bit: solves of both families equal the results frozen from
  the solver before its iteration was cut into segments
  (``tests/ipm_turn_reference.npz``).

The graph path itself runs only on the card: ``tests/test_torch_cuda.py``
holds it to the eager path there.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from obca_torch import (f32_solver_config, mixed_solver_config, nav, nlp,
                        reverse_parking_spec)
from obca_torch import spec as tspec
from obca_torch.solver import ipm, kkt
from obca_torch.solver.kernels import blocktri_se as bk
from obca_torch.warmstart import geometric, lattice

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

REFERENCE = os.path.join(os.path.dirname(__file__),
                         "ipm_turn_reference.npz")

aten = torch.ops.aten
# Operations whose result the host reads (a sync on the card) or whose
# output size depends on the data.
HOST_READS = {aten._local_scalar_dense.default, aten.nonzero.default,
              aten.masked_select.default, aten.is_nonzero.default,
              aten.equal.default, aten._unique2.default,
              aten.unique_consecutive.default,
              aten.repeat_interleave.Tensor}
INDEX_PUTS = {aten.index_put_.default, aten.index_put.default,
              aten._index_put_impl_.default}


def _shifted(base, shifts, axis):
    return tspec.stack([dataclasses.replace(base, x0=base.x0 + torch.tensor(
        [s if i == axis else 0.0 for i in range(4)], dtype=base.x0.dtype))
        for s in shifts])


@functools.lru_cache(maxsize=None)
def _case(family):
    """(specs, solver config, W0, problem module) of a family at N=20,
    B=4, as the reference was frozen; built once a family (the parking
    warm start's plan field takes seconds), and read only."""
    if family == "parking":
        base = reverse_parking_spec(N=20, Ts=1.2, device="cpu")
        lcfg = lattice.LatticeConfig.for_spec(base)
        specs = _shifted(base, (-0.2, -0.05, 0.1, 0.25), 0)
        W0 = geometric.lattice_warm_start(
            specs, cfg=lcfg, field=lattice.plan_field(base, lcfg))
        return specs, f32_solver_config(max_iter=40), W0.float(), nlp
    base = nav.nav_spec(N=20, Ts=0.75, device="cpu")
    specs = _shifted(base, (-0.3, -0.1, 0.1, 0.3), 1)
    return specs, mixed_solver_config(max_iter=30), None, nav


class _Guard(TorchDispatchMode):
    """Records every operation a card's graph capture would refuse."""

    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_READS:
            self.found.append(str(func))
        # A tensor built from a list or array (a Python scalar lifted
        # for a slice assignment becomes a fill, which captures).
        if func is aten.lift_fresh.default and args[0].dim() > 0:
            self.found.append(f"{func} of shape {tuple(args[0].shape)}")
        if func in INDEX_PUTS:
            values = args[2] if len(args) > 2 else kwargs["values"]
            if values.dim() == 0:
                self.found.append(f"{func} of a scalar")
        return func(*args, **kwargs)


@pytest.mark.parametrize("family", ["parking", "nav"])
def test_turn_is_capturable(family, monkeypatch):
    specs, cfg, W0, prob = _case(family)
    with torch.no_grad():
        state, step, _, _ = ipm._make_step(specs, cfg, W0, prob=prob)
        running = ~state.converged & (state.iters < cfg.max_iter)
        # The first turn runs eagerly (the warm-up before a capture).
        state = ipm.IpmState(*[torch.where(ipm._lane(running, a), a, b)
                               for a, b in zip(step(state), state)])
        running = ~state.converged & (state.iters < cfg.max_iter)

        calls = []
        factor = bk.factor_se

        def counted(*a):
            calls.append(a[0].shape)
            return factor(*a)

        monkeypatch.setattr(bk, "factor_se", counted)
        found = []

        def refuse(name):
            def built(*a, **kw):
                found.append(name)
                return orig[name](*a, **kw)
            return built

        orig = {n: getattr(torch, n) for n in ("tensor", "as_tensor",
                                               "from_numpy")}
        for name in orig:
            monkeypatch.setattr(torch, name, refuse(name))
        gen = ipm._graph_turn(step.turn, state, running, cfg.max_iter)
        segments, value = 0, None
        while True:
            with _Guard(found):
                done, out = kkt.resume(gen, value)
            segments += 1
            if done:
                break
            value = out.factor()
        for name, fn in orig.items():
            monkeypatch.setattr(torch, name, fn)
    assert found == []
    assert out.dtype == torch.bool and out.dim() == 0
    n_factor = 2 if cfg.soc else 1
    assert (family == "nav") == cfg.soc
    assert len(calls) == n_factor and segments == n_factor + 1


@pytest.mark.parametrize("family", ["parking", "nav"])
def test_solve_bitwise_as_frozen(family):
    """W, iterations, statuses, errors, barrier parameters and the full
    dual state equal the frozen reference exactly."""
    specs, cfg, W0, prob = _case(family)
    res = ipm.solve_batch(specs, cfg, W0, prob=prob)
    ref = np.load(REFERENCE)
    got = {k: getattr(res, k) for k in ("W", "iters", "status", "err",
                                        "mu")}
    got.update({f"duals.{f.name}": getattr(res.duals, f.name)
                for f in dataclasses.fields(ipm.DualState)})
    for k, v in got.items():
        want = ref[f"{family}.{k}"]
        assert v.dtype == torch.from_numpy(want).dtype, k
        assert np.array_equal(v.numpy(), want, equal_nan=True), k
