"""Scenario-sharded solving over a mesh of devices (and processes).

Port of ``obca_tpu.parallel.mesh``.  A batch of specs (leading axis B on
every leaf) is split contiguously over the mesh's devices; each shard
runs the same batched solver on its own device, and only the fleet
metrics are reduced across the mesh's process group (SUM and MAX
all-reduces, the JAX package's ``psum``).

Where the JAX package shards one global array over every device of the
job, each process here passes its own lanes (``distributed.
process_shard``) and gets them back in batch order on its first
device: the counterpart of the addressable shards.  A process solves
its shards one after another (each solve synchronizes with its device
every iteration); processes run side by side.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from obca_torch import spec as spec_mod
from obca_torch._util import resolve_device
from obca_torch.solver import ipm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices (repeats allowed: several shards on
    one device), the process group its metrics are reduced over (None:
    this process alone) and the axis name."""

    devices: tuple
    group: object = None
    name: str = "scenario"


def scenario_mesh(devices=None, name: str = "scenario") -> Mesh:
    """A one-process mesh over every local CUDA device, or over
    ``devices`` (anything ``torch.device`` takes).  Without a GPU and
    without ``devices`` it raises; there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("scenario_mesh: no GPU is available; pass "
                               "devices (e.g. ['cpu'] * 8) to run on the "
                               "CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devices=tuple(resolve_device(d) for d in devices), name=name)


def _cat(parts, device):
    """Concatenate same-structure results (tensors, NamedTuples,
    dataclasses) along the batch axis on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _cat([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first)})
    return type(first)(*[_cat(list(xs), device) for xs in zip(*parts)])


def _solve_shards(solve, specs, mesh: Mesh, W0=None):
    """``solve(shard_specs, shard_W0)`` on each device's contiguous share
    of the batch; the results in batch order on ``mesh.devices[0]``."""
    B, n = specs.x0.shape[0], len(mesh.devices)
    if B % n:
        raise ValueError(f"batch {B} does not divide over {n} shards")
    b = B // n
    parts = []
    for i, dev in enumerate(mesh.devices):
        lanes = slice(i * b, (i + 1) * b)
        shard = spec_mod.map_tensors(lambda t: t[lanes].to(dev), specs)
        parts.append(solve(shard, None if W0 is None else W0[lanes].to(dev)))
    return _cat(parts, mesh.devices[0])


def _metrics(res, mesh: Mesh, with_obj: bool):
    """Converged count, max KKT error, mean iterations (and mean
    objective) over every lane of the mesh: float64 sums and the max
    all-reduced over ``mesh.group`` on its backend's device, the means
    divided after the sum."""
    if mesh.group is None:
        dev = mesh.devices[0]
    elif dist.get_backend(mesh.group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    f64 = torch.float64
    sums = torch.stack([
        (res.status == ipm.STATUS_CONVERGED).sum().to(f64),
        res.iters.to(f64).sum(),
        res.obj.to(f64).sum() if with_obj else torch.zeros(
            (), dtype=f64, device=res.obj.device),
        torch.tensor(float(res.status.shape[0]), dtype=f64,
                     device=res.obj.device)]).to(dev)
    mx = res.err.to(f64).max().reshape(1).to(dev)
    if mesh.group is not None:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
    home = mesh.devices[0]
    out = {
        "n_converged": sums[0].round().to(torch.int64),
        "max_err": mx[0].to(res.err.dtype),
        "mean_iters": (sums[1] / sums[3]).to(torch.float32),
    }
    if with_obj:
        out["mean_obj"] = (sums[2] / sums[3]).to(res.obj.dtype)
    return {k: v.to(home) for k, v in out.items()}


def solve_sharded(specs, cfg, mesh: Mesh, W0=None,
                  with_metrics: bool = True):
    """Solve this process's lanes (stacked specs, W0 [B, N+1, nw] or
    None) with ``ipm.solve_batch``, split over the mesh's devices; B
    must divide over them.  Returns the SolveResult in batch order on
    ``mesh.devices[0]`` and, with ``with_metrics``, the mesh-wide
    ``n_converged``, ``max_err``, ``mean_iters`` and ``mean_obj``."""
    res = _solve_shards(lambda sp, w: ipm.solve_batch(sp, cfg, w), specs,
                        mesh, W0)
    return res, (_metrics(res, mesh, True) if with_metrics else {})


def make_sharded_solver(pipeline, mesh: Mesh):
    """A runner ``run(specs) -> (SolveResult, metrics)`` of a batched
    solve ``pipeline(specs) -> SolveResult`` over the mesh, with the
    mesh-wide ``n_converged``, ``max_err`` and ``mean_iters``.  Build it
    once and call it repeatedly (timed repetitions)."""
    def runner(specs):
        res = _solve_shards(lambda sp, _w: pipeline(sp), specs, mesh)
        return res, _metrics(res, mesh, False)

    return runner


def solve_sharded_fn(pipeline, specs, mesh: Mesh):
    """One call of :func:`make_sharded_solver`'s runner."""
    return make_sharded_solver(pipeline, mesh)(specs)


def dryrun_step(specs, cfg, mesh: Mesh):
    """One sharded solve, synchronized with every device of the mesh:
    that the whole solver runs under a mesh."""
    res, metrics = solve_sharded(specs, cfg, mesh)
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return res, metrics
