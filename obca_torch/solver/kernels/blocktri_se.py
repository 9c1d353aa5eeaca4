"""Structured-coupling block-tridiagonal kernels: CUDA wrappers and their
plain PyTorch versions.

Port of the kernels that ``obca_tpu.solver.kkt.make_kkt_solver_se``
runs on every IPM iteration (``obca_tpu/solver/pallas/
blocktri_kernel.py``: ``factor_batched_se``, ``fwd_se``,
``bwd_matvec_se`` on the single-precision route, and
``solve_batched_se`` — ``fwd_se`` then ``bwd_se`` here — on the
mixed-precision route).  The layout is batch-major — K [B, S, nz, nz],
ev [B, S-1, nnz], vectors [B, S, nz] — which is what the IPM holds, so
no transposes or padding surround the calls.  The coupling block E_k
has values ev[:, k] at the static positions (rows, cols).

Each wrapper takes the plain version for a tensor on the CPU.  For a
CUDA tensor it checks dtype (float32), shape, contiguity and device,
launches the hand-written kernel on the current stream and counts the
launch in :data:`launches`, or raises; it never falls back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# launches, reset_launches and NZ_MAX are re-exported: one count and one
# cap for all kernels.
from obca_torch.solver.kernels.runtime import (  # noqa: F401
    NZ_MAX, check, check_nz, launch, launches, on_cpu, reset_launches)


@dataclasses.dataclass(frozen=True, eq=False)
class CouplingPattern:
    """Static sparsity of E: rows/cols [nnz], the sorted distinct
    columns ucols [C] and cidx [nnz] (position of cols[j] in ucols).
    :meth:`lists` gives the entries of each row and of each column."""

    rows: np.ndarray
    cols: np.ndarray
    ucols: np.ndarray
    cidx: np.ndarray
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def of(rows, cols) -> "CouplingPattern":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        ucols = np.unique(cols)
        cidx = np.searchsorted(ucols, cols)
        return CouplingPattern(rows, cols, ucols, cidx)

    def index(self, device, dtype=torch.int64) -> dict:
        """The four index arrays as tensors on ``device`` (cached)."""
        key = (str(device), dtype)
        if key not in self._cache:
            self._cache[key] = {
                n: torch.as_tensor(getattr(self, n), dtype=dtype,
                                   device=device)
                for n in ("rows", "cols", "ucols", "cidx")}
        return self._cache[key]

    def lists(self, nz) -> dict:
        """The coupling entries of each of nz rows, as numpy arrays: the
        j with rows[j] == i are rent[rstart[i]:rstart[i + 1]], the j
        with cols[j] == i are cent[cstart[i]:cstart[i + 1]], each in
        increasing j; rstart and cstart have nz + 1 entries."""
        out = {}
        for k, idx in (("r", self.rows), ("c", self.cols)):
            ent = np.argsort(idx, kind="stable")
            out[f"{k}start"] = np.searchsorted(idx[ent], np.arange(nz + 1))
            out[f"{k}ent"] = ent
        return out

    def lists_index(self, nz, device) -> dict:
        """:meth:`lists` as int32 tensors on ``device`` (cached)."""
        key = ("lists", nz, str(device))
        if key not in self._cache:
            self._cache[key] = {
                n: torch.as_tensor(a, dtype=torch.int32, device=device)
                for n, a in self.lists(nz).items()}
        return self._cache[key]


# ---------------------------------------------------------------------------
# Plain versions (the CPU route and the reference on the card).
# ---------------------------------------------------------------------------


def matvec_se(K, ev, pat: CouplingPattern, x):
    """Block-tridiagonal matvec T x with the coupling as sparse values:
    K [B, S, nz, nz], ev [B, S-1, nnz], x [B, S, nz]."""
    ix = pat.index(x.device)
    out = (K @ x[..., None])[..., 0]
    # (E_k x_{k+1})[rows_j] += ev_j x_{k+1}[cols_j]
    out[:, :-1].index_add_(2, ix["rows"], ev * x[:, 1:, ix["cols"]])
    # (E'_{k-1} x_{k-1})[cols_j] += ev_j x_{k-1}[rows_j]
    out[:, 1:].index_add_(2, ix["cols"], ev * x[:, :-1, ix["rows"]])
    return out


def factor_se_plain(K, ev, reg, pat: CouplingPattern):
    """Plain version of :func:`factor_se`: the same Schur recursion, each
    stage inverted by LU with partial pivoting (``torch.linalg.inv``),
    the pivoting the kernel's Gauss-Jordan elimination does."""
    B, S, nz, _ = K.shape
    ix = pat.index(K.device)
    C = len(pat.ucols)
    d = torch.arange(nz, device=K.device)
    Kr = K.clone()
    Kr[:, :, d, d] += reg[:, None, :]
    Sinv = torch.empty_like(K)
    Wc = torch.empty((B, S - 1, nz, C), dtype=K.dtype, device=K.device)
    Sinv[:, 0] = torch.linalg.inv(Kr[:, 0])
    uc = ix["ucols"]
    for k in range(1, S):
        evk = ev[:, k - 1]
        t = Sinv[:, k - 1][:, :, ix["rows"]] * evk[:, None, :]   # [B,nz,nnz]
        Wk = torch.zeros((B, nz, C), dtype=K.dtype, device=K.device)
        Wk.index_add_(2, ix["cidx"], t)
        U = torch.zeros((B, C, C), dtype=K.dtype, device=K.device)
        U.index_add_(1, ix["cidx"], evk[:, :, None] * Wk[:, ix["rows"], :])
        Sk = Kr[:, k].clone()
        Sk[:, uc[:, None], uc[None, :]] -= U
        Sinv[:, k] = torch.linalg.inv(Sk)
        Wc[:, k - 1] = Wk
    return Sinv, Wc


def fwd_se_plain(Sinv, ev, r, pat: CouplingPattern):
    """Plain version of :func:`fwd_se`."""
    ix = pat.index(r.device)
    y = torch.empty_like(r)
    y[:, 0] = (Sinv[:, 0] @ r[:, 0, :, None])[..., 0]
    for k in range(1, r.shape[1]):
        t = ev[:, k - 1] * y[:, k - 1][:, ix["rows"]]
        sub = torch.zeros_like(r[:, k]).index_add_(1, ix["cols"], t)
        y[:, k] = (Sinv[:, k] @ (r[:, k] - sub)[..., None])[..., 0]
    return y


def bwd_se_plain(Wc, y, pat: CouplingPattern):
    """Plain version of :func:`bwd_se`."""
    ix = pat.index(y.device)
    S = y.shape[1]
    p = torch.empty_like(y)
    p[:, S - 1] = y[:, S - 1]
    for s in range(S - 2, -1, -1):
        pu = p[:, s + 1][:, ix["ucols"]]
        p[:, s] = y[:, s] - (Wc[:, s] @ pu[..., None])[..., 0]
    return p


def bwd_matvec_se_plain(Wc, y, K, ev, pat: CouplingPattern):
    """Plain version of :func:`bwd_matvec_se`."""
    p = bwd_se_plain(Wc, y, pat)
    return p, matvec_se(K, ev, pat, p)


def solve_se_plain(Sinv, Wc, ev, r, pat: CouplingPattern):
    """Plain version of :func:`solve_se`."""
    return bwd_se_plain(Wc, fwd_se_plain(Sinv, ev, r, pat), pat)


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------


def _check_pattern(kernel, pat, nz):
    """The kernels index with the pattern unchecked: keep it in range."""
    if min(pat.rows.min(), pat.cols.min()) < 0 or \
            max(pat.rows.max(), pat.cols.max()) >= nz:
        raise ValueError(f"{kernel}: coupling pattern outside [0, {nz})")


def factor_se(K, ev, reg, pat: CouplingPattern):
    """Sparse-coupling factorization.

    K [B, S, nz, nz] UNregularized diagonal blocks, ev [B, S-1, nnz],
    reg [B, nz] (diagonal regularization added in-kernel).  Returns
    (Sinv [B, S, nz, nz], Wc [B, S-1, nz, C]) with
    Wc[:, k][:, :, c] = (S_k^{-1} E_k)[:, ucols[c]] — slot k holds
    stage k's product.
    """
    if on_cpu("factor_se", K):
        return factor_se_plain(K, ev, reg, pat)
    B, S, nz, _ = K.shape
    nnz, C = len(pat.rows), len(pat.ucols)
    dev = K.device
    check_nz("factor_se", nz)
    _check_pattern("factor_se", pat, nz)
    check("factor_se", "K", K, (B, S, nz, nz), dev)
    check("factor_se", "ev", ev, (B, S - 1, nnz), dev)
    check("factor_se", "reg", reg, (B, nz), dev)
    ix = pat.index(dev, torch.int32)
    Sinv = torch.empty_like(K)
    Wc = torch.empty((B, S - 1, nz, C), dtype=K.dtype, device=dev)
    launch("factor_se", dev, K, ev, reg, ix["rows"], ix["cidx"],
           ix["ucols"], B, S, nz, nnz, C, Sinv, Wc)
    return Sinv, Wc


def fwd_se(Sinv, ev, r, pat: CouplingPattern):
    """Forward substitution y_k = Sinv_k (r_k - E'_{k-1} y_{k-1});
    Sinv [B, S, nz, nz], ev [B, S-1, nnz], r [B, S, nz] -> y."""
    if on_cpu("fwd_se", r):
        return fwd_se_plain(Sinv, ev, r, pat)
    B, S, nz = r.shape
    nnz = len(pat.rows)
    dev = r.device
    check_nz("fwd_se", nz)
    _check_pattern("fwd_se", pat, nz)
    check("fwd_se", "Sinv", Sinv, (B, S, nz, nz), dev)
    check("fwd_se", "ev", ev, (B, S - 1, nnz), dev)
    check("fwd_se", "r", r, (B, S, nz), dev)
    ix = pat.index(dev, torch.int32)
    y = torch.empty_like(r)
    launch("fwd_se", dev, Sinv, ev, r, ix["rows"], ix["cols"], B, S, nz,
           nnz, y)
    return y


def bwd_matvec_se(Wc, y, K, ev, pat: CouplingPattern):
    """Backward substitution p_s = y_s - Wc_s p_{s+1}[ucols] fused with
    the true-system matvec Ap = T p (K unregularized).  Returns (p, Ap),
    each [B, S, nz]."""
    if on_cpu("bwd_matvec_se", y):
        return bwd_matvec_se_plain(Wc, y, K, ev, pat)
    B, S, nz = y.shape
    nnz, C = len(pat.rows), len(pat.ucols)
    dev = y.device
    check_nz("bwd_matvec_se", nz)
    _check_pattern("bwd_matvec_se", pat, nz)
    check("bwd_matvec_se", "Wc", Wc, (B, S - 1, nz, C), dev)
    check("bwd_matvec_se", "y", y, (B, S, nz), dev)
    check("bwd_matvec_se", "K", K, (B, S, nz, nz), dev)
    check("bwd_matvec_se", "ev", ev, (B, S - 1, nnz), dev)
    ix = pat.index(dev, torch.int32)
    lst = pat.lists_index(nz, dev)
    p = torch.empty_like(y)
    Ap = torch.empty_like(y)
    launch("bwd_matvec_se", dev, Wc, y, K, ev, ix["rows"], ix["cols"],
           ix["ucols"], lst["rstart"], lst["rent"], lst["cstart"],
           lst["cent"], B, S, nz, nnz, C, p, Ap)
    return p, Ap


def bwd_se(Wc, y, pat: CouplingPattern):
    """Backward substitution p_{S-1} = y_{S-1},
    p_s = y_s - Wc_s p_{s+1}[ucols]; Wc [B, S-1, nz, C], y [B, S, nz]
    -> p [B, S, nz]."""
    if on_cpu("bwd_se", y):
        return bwd_se_plain(Wc, y, pat)
    B, S, nz = y.shape
    C = len(pat.ucols)
    dev = y.device
    check_nz("bwd_se", nz)
    _check_pattern("bwd_se", pat, nz)
    check("bwd_se", "Wc", Wc, (B, S - 1, nz, C), dev)
    check("bwd_se", "y", y, (B, S, nz), dev)
    ix = pat.index(dev, torch.int32)
    p = torch.empty_like(y)
    launch("bwd_se", dev, Wc, y, ix["ucols"], B, S, nz, C, p)
    return p


def solve_se(Sinv, Wc, ev, r, pat: CouplingPattern):
    """Solve T x = r through the factor (Sinv, Wc) of
    :func:`factor_se`: :func:`fwd_se`, then :func:`bwd_se`.  The
    counterpart of the TPU's ``solve_batched_se``."""
    return bwd_se(Wc, fwd_se(Sinv, ev, r, pat), pat)
