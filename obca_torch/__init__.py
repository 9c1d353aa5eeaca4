"""obca_torch: batched OBCA trajectory optimization in PyTorch + CUDA.

A port of ``obca_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
GPU.  The module layout mirrors ``obca_tpu``; public function names
match their counterparts.  Where JAX ``vmap``s over scenarios, the port
carries an explicit leading batch dimension B.

Float32 precision: the f32 fast path only converges when every f32
matrix product runs in full f32 (the JAX package forces "highest"
matmul precision for the same reason).  TF32 keeps about three decimal
digits, so the package turns it off for both cuBLAS and cuDNN when it
is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from obca_torch.spec import (  # noqa: E402
    Obstacles,
    ProblemSpec,
    SolverConfig,
    f32_solver_config,
    mixed_solver_config,
    parallel_fastpath_config,
    parallel_parking_spec,
    randomized_parallel_parking_specs,
    randomized_reverse_parking_specs,
    reverse_parking_spec,
)

__all__ = [
    "Obstacles",
    "ProblemSpec",
    "SolverConfig",
    "f32_solver_config",
    "mixed_solver_config",
    "parallel_fastpath_config",
    "parallel_parking_spec",
    "randomized_parallel_parking_specs",
    "randomized_reverse_parking_specs",
    "reverse_parking_spec",
]
