"""The benchmark of obca_torch on one NVIDIA GPU: runs one cell once.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

run from the root of a checkout.  The last line of standard output is
the result (JSON); the numbers compared with the plain reference, each
beside its limit, are the last lines of standard error.  Exits non-zero,
printing no result, without enough CUDA devices for the cell or if JAX
or the JAX package was loaded.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench_cache")
# Kernel and build caches at fixed paths inside the checkout.  The
# program's own kernels build into obca_torch/_build/.
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(t_start=T_START))
