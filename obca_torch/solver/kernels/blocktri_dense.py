"""Dense-coupling block-tridiagonal kernels: CUDA wrappers and their
plain PyTorch versions.

Port of the kernels that ``obca_tpu.solver.kkt.make_kkt_solver`` runs
(``obca_tpu/solver/pallas/blocktri_kernel.py``: ``factor_batched`` and
``solve_batched``, whose two halves are ``fwd_dense`` and ``bwd_dense``
here).  Batch-major layout: K, Sinv [B, S, nz, nz], E, W
[B, S-1, nz, nz], vectors [B, S, nz].  Slot k of W holds S_k^{-1} E_k.

The wrappers follow the rules of ``blocktri_se``: the plain version for
a CPU tensor; for a CUDA tensor float32, shape, contiguity and device
are checked, the kernel is launched and counted in the shared
``runtime.launches``, or the call raises.  All three take nz up to
``NZ_MAX`` (128) on the card and raise above it.
"""

from __future__ import annotations

import torch

from obca_torch.solver import blocktri
from obca_torch.solver.kernels.runtime import (  # noqa: F401
    NZ_MAX, check, check_nz, launch, on_cpu)


def factor_dense_plain(K, E):
    """Plain version of :func:`factor_dense`: ``blocktri.factor`` with
    each stage inverted by LU with partial pivoting
    (``torch.linalg.inv``), the pivoting the kernel's Gauss-Jordan
    elimination does."""
    fac = blocktri.factor(K, E)
    return fac.Sinv, fac.W


# Plain versions of fwd_dense and bwd_dense.
fwd_dense_plain = blocktri.fwd_subst
bwd_dense_plain = blocktri.bwd_subst


def solve_dense_plain(Sinv, W, E, r):
    """Plain version of :func:`solve_dense`."""
    return bwd_dense_plain(W, fwd_dense_plain(Sinv, E, r))


def factor_dense(K, E):
    """Dense-coupling factorization.

    K [B, S, nz, nz] diagonal blocks with the factor's regularization
    already on the diagonal, E [B, S-1, nz, nz] upper coupling blocks.
    Returns (Sinv [B, S, nz, nz], W [B, S-1, nz, nz]) with
    W[:, k] = S_k^{-1} E_k.
    """
    if on_cpu("factor_dense", K):
        return factor_dense_plain(K, E)
    B, S, nz, _ = K.shape
    dev = K.device
    check_nz("factor_dense", nz)
    check("factor_dense", "K", K, (B, S, nz, nz), dev)
    check("factor_dense", "E", E, (B, S - 1, nz, nz), dev)
    Sinv = torch.empty_like(K)
    W = torch.empty_like(E)
    launch("factor_dense", dev, K, E, B, S, nz, Sinv, W)
    return Sinv, W


def fwd_dense(Sinv, E, r):
    """Forward substitution y_k = Sinv_k (r_k - E'_{k-1} y_{k-1})."""
    if on_cpu("fwd_dense", r):
        return fwd_dense_plain(Sinv, E, r)
    B, S, nz = r.shape
    dev = r.device
    check_nz("fwd_dense", nz)
    check("fwd_dense", "Sinv", Sinv, (B, S, nz, nz), dev)
    check("fwd_dense", "E", E, (B, S - 1, nz, nz), dev)
    check("fwd_dense", "r", r, (B, S, nz), dev)
    y = torch.empty_like(r)
    launch("fwd_dense", dev, Sinv, E, r, B, S, nz, y)
    return y


def bwd_dense(W, y):
    """Backward substitution x_{S-1} = y_{S-1}, x_k = y_k - W_k x_{k+1}."""
    if on_cpu("bwd_dense", y):
        return bwd_dense_plain(W, y)
    B, S, nz = y.shape
    dev = y.device
    check_nz("bwd_dense", nz)
    check("bwd_dense", "W", W, (B, S - 1, nz, nz), dev)
    check("bwd_dense", "y", y, (B, S, nz), dev)
    x = torch.empty_like(y)
    launch("bwd_dense", dev, W, y, B, S, nz, x)
    return x


def solve_dense(Sinv, W, E, r):
    """Solve T x = r through the factor of :func:`factor_dense`: the
    counterpart of the TPU's ``solve_batched``."""
    return bwd_dense(W, fwd_dense(Sinv, E, r))
