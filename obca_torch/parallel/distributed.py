"""Multi-process initialization and the global scenario mesh, over
``torch.distributed``.

Port of ``obca_tpu.parallel.distributed``.  Every process runs the same
program on its shard of the scenario batch: it builds only its lanes
(:func:`process_shard`) and solves them on its own device; the metric
all-reduces cross processes.  This module is the only place that starts
a process group; single-process runs never call it.

Usage (once per process, before the solve):

    from obca_torch.parallel import distributed
    distributed.initialize("localhost:29500", num_processes=2,
                           process_id=rank)
    mesh = distributed.global_scenario_mesh()
    lanes = distributed.process_shard(n_total)

With every argument None it reads torchrun's environment (``env://``:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from obca_torch._util import resolve_device
from obca_torch.parallel.mesh import Mesh

# The devices this process solves on, set once by initialize (like the
# process group itself, they belong to the process).
_rank_devices: tuple = ()


def _device(spec) -> torch.device:
    """An int names a CUDA ordinal; anything else goes to torch.device."""
    if isinstance(spec, int):
        return resolve_device(f"cuda:{spec}")
    return resolve_device(spec)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, backend: str | None = None) -> None:
    """Join the process group, once per process (later calls return).

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` go to ``init_process_group`` as a ``tcp://`` rendezvous
    with that world size and rank; all None reads torchrun's environment
    (``env://``).  ``local_device_ids`` names this process's devices:
    CUDA ordinals, or device strings such as ``"cpu"`` (default
    ``cuda:<local rank>``, the local rank from LOCAL_RANK, else the
    rank).  ``backend`` defaults to ``"nccl"`` for a CUDA device and
    ``"gloo"`` for the CPU; NCCL without a GPU raises, and nothing
    switches backend on its own.
    """
    global _rank_devices
    if dist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit) and None in explicit:
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id together, or none")
    if coordinator_address is None:
        init = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
        rank = process_id
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    ids = [local_rank] if local_device_ids is None else list(
        local_device_ids)
    devices = tuple(_device(i) for i in ids)
    backend = backend or ("nccl" if devices[0].type == "cuda" else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: the NCCL backend needs a GPU, "
                               "and none is available")
        if devices[0].type != "cuda":
            raise ValueError(f"initialize: the NCCL backend needs a CUDA "
                             f"device, got {devices[0]}")
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, **init)
    _rank_devices = devices


def global_scenario_mesh(name: str = "scenario") -> Mesh:
    """The mesh of this process's devices and the whole job's process
    group (every process a member)."""
    if not dist.is_initialized():
        raise RuntimeError("global_scenario_mesh: call initialize first")
    return Mesh(devices=_rank_devices, group=dist.group.WORLD, name=name)


def process_shard(n_total: int) -> slice:
    """The contiguous lanes this process builds and solves of a global
    batch of ``n_total`` scenarios: ceil(n_total / processes) each, the
    last process the rest (all of them without a process group)."""
    p, n = ((dist.get_rank(), dist.get_world_size())
            if dist.is_initialized() else (0, 1))
    per = -(-n_total // n)
    lo = min(p * per, n_total)
    return slice(lo, min(lo + per, n_total))
