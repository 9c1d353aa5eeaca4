"""obca_torch's scenario sharding against obca_tpu's, on the CPU.

The batch of ``tests/test_parallel.py`` (8 start shifts of
``reverse_parking_spec(N=8, Ts=2.0)`` with its x0 / xF,
``SolverConfig(max_iter=10)``, float64), from the port's lattice warm
start, the same W0 to both packages.  From the cold start the
10-iteration iterates are mid-solve on ill-conditioned systems, and the
two packages' linear solves (the port's factor pivots, the JAX
package's does not) take them far more than 1e-6 apart in U; from the
warm start they agree well within it.

* ``mesh.solve_sharded`` on an in-process mesh of 8 CPU shards against
  JAX's ``solve_sharded`` on the conftest's 8 faked devices: U within
  1e-6, the converged count and mean iterations equal, the max error and
  mean objective within 1e-6 relative (the KKT error of a mid-solve
  iterate carries the linear solves' rounding);
* ``make_sharded_solver`` with ``ipm.solve_batch`` from the warm start
  as the pipeline against JAX's, likewise with its three metrics;
* two processes over gloo (modelled on ``tests/test_multiprocess.py``):
  each imports only ``obca_torch``, joins the group on a free port,
  solves its ``process_shard`` of a 4-lane batch (specs and W0 from an
  npz file the test writes) and writes its lanes
  and the all-reduced metrics; the gathered U must be within 1e-6 of
  JAX's ``solve_batch`` on the same batch, and the reduced metrics
  equal on both ranks and to JAX's.  ``OBCA_SKIP_MULTIPROC=1`` skips it;
* ``initialize``'s argument check and ``process_shard`` without a group.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import spec as spec_mod
from obca_torch.convert import (config_from_numpy, specs_from_numpy,
                                to_numpy_tree)
from obca_torch.parallel import distributed
from obca_torch.parallel import mesh as tmesh
from obca_torch.solver import ipm
from obca_torch.warmstart import geometric, lattice
from obca_tpu.parallel import mesh as jmesh
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import SolverConfig as JSolverConfig
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

U_ATOL = 1e-6
REL = 1e-6


def _jax_specs(n, spread):
    """tests/test_parallel.py's batch: the list of n lanes."""
    base = dataclasses.replace(
        j_reverse_parking_spec(N=8, Ts=2.0),
        x0=jnp.asarray([-8.0, 7.0, 0.0, 0.5]),
        xF=jnp.asarray([6.0, 8.0, 0.0, 0.5]))
    return [dataclasses.replace(base, x0=base.x0.at[0].add(s))
            for s in jnp.linspace(-spread, spread, n)]


def _stack(jspecs):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *jspecs)


def _port_batch(jspecs):
    """The port's batch and a warm start of it from one shared lattice
    field (the geometry is the same in every lane): (specs, warm)."""
    specs = specs_from_numpy([to_numpy_tree(s) for s in jspecs],
                             device="cpu")
    base = spec_mod.take(specs, 0)
    lcfg = lattice.LatticeConfig.for_spec(base)
    field = lattice.plan_field(base, lcfg)

    def warm(s):
        return geometric.lattice_warm_start(s, cfg=lcfg, field=field)

    return specs, warm


@pytest.fixture(scope="module")
def case():
    """(JAX batch, port batch, JAX config, port config, W0, the warm
    start of a batch)."""
    jspecs = _jax_specs(8, 0.4)
    cfg = JSolverConfig(max_iter=10)
    specs, warm = _port_batch(jspecs)
    return (_stack(jspecs), specs, cfg,
            config_from_numpy(to_numpy_tree(cfg)), warm(specs), warm)


def _check_metrics(got, want):
    assert set(got) == set(want)
    assert int(got["n_converged"]) == int(want["n_converged"])
    assert float(got["mean_iters"]) == float(want["mean_iters"])
    for k in set(got) - {"n_converged", "mean_iters"}:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL)


def test_solve_sharded_matches_jax(case):
    jspecs, specs, jcfg, cfg, W0, _ = case
    jres, jmet = jmesh.solve_sharded(jspecs, jcfg, jmesh.scenario_mesh(),
                                     jnp.asarray(W0.numpy()))
    mesh = tmesh.scenario_mesh(["cpu"] * 8)
    res, met = tmesh.solve_sharded(specs, cfg, mesh, W0)
    np.testing.assert_allclose(res.U.numpy(), np.asarray(jres.U), rtol=0,
                               atol=U_ATOL)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    _check_metrics(met, jmet)
    # The shards' lanes come back in batch order: as one unsharded solve
    # (to rounding: torch's CPU kernels may sum a batch of one lane in
    # another order than a batch of eight).
    one = ipm.solve_batch(specs, cfg, W0)
    torch.testing.assert_close(res.U, one.U, rtol=0, atol=1e-12)


def test_make_sharded_solver_matches_jax(case):
    jspecs, specs, jcfg, cfg, W0, warm = case
    W0j = jnp.asarray(W0.numpy())
    jres, jmet = jmesh.make_sharded_solver(
        lambda s: jipm.solve_batch(s, jcfg, W0j), jmesh.scenario_mesh())(
        jspecs)

    def pipeline(s):
        return ipm.solve_batch(s, cfg, warm(s))

    run = tmesh.make_sharded_solver(pipeline,
                                    tmesh.scenario_mesh(["cpu"] * 4))
    res, met = run(specs)
    np.testing.assert_allclose(res.U.numpy(), np.asarray(jres.U), rtol=0,
                               atol=U_ATOL)
    _check_metrics(met, jmet)
    res2, met2 = tmesh.solve_sharded_fn(pipeline, specs,
                                        tmesh.scenario_mesh(["cpu"]))
    torch.testing.assert_close(res2.U, res.U, rtol=0, atol=1e-12)
    _check_metrics(met2, met)


def test_dryrun_step_and_uneven_batch(case):
    _, specs, _, cfg, _, _ = case
    res, met = tmesh.dryrun_step(specs, cfg, tmesh.scenario_mesh(["cpu"] * 2))
    assert res.U.shape == (8, 8, 2) and set(met) == {
        "n_converged", "max_err", "mean_iters", "mean_obj"}
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.solve_sharded(specs, cfg, tmesh.scenario_mesh(["cpu"] * 3))


def test_initialize_arguments_and_process_shard():
    """A partial rendezvous is refused; without a process group one
    process builds every lane (the refusals without a GPU are in
    tests/test_torch_cuda.py)."""
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("localhost:1")
    assert distributed.process_shard(5) == slice(0, 5)


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


_WORKER = r"""
import sys
rank, world, port, repo, inp, out = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from obca_torch import SolverConfig
from obca_torch import spec as spec_mod
from obca_torch.convert import spec_from_numpy
from obca_torch.parallel import distributed
from obca_torch.parallel import mesh as mesh_mod

distributed.initialize(f"localhost:{port}", num_processes=world,
                       process_id=rank, local_device_ids=["cpu"])
mesh = distributed.global_scenario_mesh()
flat = np.load(inp)
tree = {}
for key in flat.files:
    *path, leaf = key.split("/")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = flat[key]
W0 = torch.as_tensor(tree.pop("W0"))
specs = spec_from_numpy(tree, device="cpu")
lanes = distributed.process_shard(specs.x0.shape[0])
res, met = mesh_mod.solve_sharded(spec_mod.take(specs, lanes),
                                  SolverConfig(max_iter=10), mesh,
                                  W0[lanes])
np.savez(out, U=res.U.numpy(), lo=lanes.start,
         **{k: v.numpy() for k, v in met.items()})
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "obca_tpu")]
assert not bad, bad
print("WORKER_OK", rank)
"""


@pytest.mark.skipif(os.environ.get("OBCA_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_gloo_matches_jax(tmp_path):
    jspecs = _jax_specs(4, 0.2)
    jbatch = _stack(jspecs)
    specs, warm = _port_batch(jspecs)
    W0 = warm(specs).numpy()
    inp = tmp_path / "batch.npz"
    np.savez(inp, W0=W0, **_flat(to_numpy_tree(jbatch)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), "2", port, repo, str(inp),
         str(tmp_path / f"out{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=repo, env=env,
        text=True) for rank in range(2)]
    # JAX's reference while the workers run.
    jres = jax.jit(lambda ss, w: jipm.solve_batch(
        ss, JSolverConfig(max_iter=10), w))(jbatch, jnp.asarray(W0))
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        assert "WORKER_OK" in out
    outs = [np.load(tmp_path / f"out{rank}.npz") for rank in range(2)]
    assert [int(o["lo"]) for o in outs] == [0, 2]
    U = np.concatenate([o["U"] for o in outs])
    np.testing.assert_allclose(U, np.asarray(jres.U), rtol=0, atol=U_ATOL)
    for k in ("n_converged", "max_err", "mean_iters", "mean_obj"):
        assert outs[0][k] == outs[1][k], k
    status = np.asarray(jres.status)
    assert int(outs[0]["n_converged"]) == int(
        (status == jipm.STATUS_CONVERGED).sum())
    np.testing.assert_allclose(float(outs[0]["max_err"]),
                               float(np.max(np.asarray(jres.err))), rtol=REL)
    assert float(outs[0]["mean_iters"]) == float(
        np.mean(np.asarray(jres.iters)))
