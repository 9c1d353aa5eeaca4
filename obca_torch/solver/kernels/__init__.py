"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain
PyTorch versions.  Sources live in ``csrc/``; ``build`` compiles them
at first use.  Nothing here touches CUDA or nvcc at import time."""
