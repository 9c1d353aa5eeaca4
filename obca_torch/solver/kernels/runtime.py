"""What every kernel wrapper shares: the C entry points and their ctypes
signatures, the launch counts, and the checks made before a launch.

A wrapper takes its kernel's plain PyTorch version for a tensor on the
CPU (:func:`on_cpu`).  For a CUDA tensor it checks each input with
:func:`check`, then :func:`launch` runs the kernel on the current
stream and counts it in :data:`launches`, or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset (only real CUDA launches count).
launches = {name: 0 for name in (
    "factor_se", "fwd_se", "bwd_matvec_se", "bwd_se",
    "factor_dense", "fwd_dense", "bwd_dense", "stream_add_one",
    "fma_probe", "ruiz_se")}


def reset_launches():
    for k in launches:
        launches[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# kernel -> (library in csrc/, C entry point, argument types; the stream
# is the last argument of every entry point).
SIGNATURES = {
    "factor_se": ("factor_se", "obca_factor_se_f32",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]),
    "fwd_se": ("fwd_se", "obca_fwd_se_f32",
               [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "bwd_matvec_se": ("bwd_matvec_se", "obca_bwd_matvec_se_f32",
                      [_P] * 11 + [_I] * 5 + [_P, _P, _P]),
    "bwd_se": ("bwd_se", "obca_bwd_se_f32",
               [_P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "factor_dense": ("factor_dense", "obca_factor_dense_f32",
                     [_P, _P, _I, _I, _I, _P, _P, _P]),
    "fwd_dense": ("solve_dense", "obca_fwd_dense_f32",
                  [_P, _P, _P, _I, _I, _I, _P, _P]),
    "bwd_dense": ("solve_dense", "obca_bwd_dense_f32",
                  [_P, _P, _I, _I, _I, _P, _P]),
    "stream_add_one": ("probes", "obca_stream_add_one_f32",
                       [_P, _P, _L, _P]),
    "fma_probe": ("probes", "obca_fma_probe_f32", [_P, _P, _L, _P]),
    # One entry point for float32 and float64 (its element size in bytes).
    "ruiz_se": ("ruiz_se", "obca_ruiz_se", [_P] * 9 + [_I] * 6 + [_P] * 6),
}

_entries: dict = {}


def _entry(name):
    """(library, C entry point with its ctypes signature) of a kernel,
    built and loaded at first use."""
    if name not in _entries:
        from obca_torch.solver.kernels import build

        lib_name, sym, argtypes = SIGNATURES[name]
        lib = build.load(lib_name)
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = (lib, fn)
    return _entries[name]


def on_cpu(kernel, t):
    """True for a CPU tensor (plain route); False for a CUDA tensor
    (kernel route); any other device is refused."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    return t.device.type == "cpu"


# The largest stage size nz that the block-tridiagonal kernels take; a
# larger nz on the card raises.  Each kernel has two compile-time
# instantiations, one for nz <= NZ_NARROW and one for NZ_NARROW < nz <=
# NZ_MAX (the wide one), and its entry point picks one by nz at launch.
NZ_NARROW = 64
NZ_MAX = 128


def check_nz(kernel, nz):
    if nz > NZ_MAX:
        raise ValueError(f"{kernel}: nz={nz} is above the kernel's cap "
                         f"NZ_MAX={NZ_MAX}")


def check(kernel, what, t, shape, device, dtypes=(torch.float32,)):
    if t.device != device:
        raise ValueError(f"{kernel}: {what} is on {t.device}, "
                         f"expected {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{kernel}: {what} must be {names} on CUDA, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be contiguous")


def launch(name, device, *args):
    lib, fn = _entry(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    rc = fn(*conv, stream)
    if rc != 0:
        msg = lib.obca_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    launches[name] += 1
