"""Scale-out: scenario-parallel solving over devices and processes.

Port of ``obca_tpu.parallel``.  A batch of specs is split along its
leading axis over a 1-D ``scenario`` mesh of devices (and, with
``torch.distributed``, of processes); each shard runs the same batched
solver on its own device, and the only communication is the all-reduce
of a few fleet metrics.
"""

from obca_torch.parallel import mesh  # noqa: F401
