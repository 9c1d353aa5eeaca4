"""KKT linear-system solvers for the batched IPM.

Port of ``obca_tpu.solver.kkt``: ``make_kkt_solver_se`` (the coupling
as sparse values, what the IPM runs) and ``make_kkt_solver`` (dense
coupling blocks).  The JAX package dispatches per scenario (XLA) or,
under ``vmap`` on a TPU, to the batch-in-lanes Pallas kernels.  The
port always holds the batch, so each solver has one route: the
hand-written CUDA kernels of ``obca_torch.solver.kernels`` on a CUDA
tensor, their plain PyTorch versions on a CPU tensor, with GCR(m)
refinement against the true (unregularized) system.  Layout stays
batch-major [B, S, nz, nz]; the TPU's transposes and (8, 128) padding
are not needed.  On the card the kernels take float32 only, so a
factor dtype other than float32 raises ``TypeError`` there.
"""

from __future__ import annotations

import torch

from obca_torch.solver.blocktri import gcr as _gcr_batched
from obca_torch.solver.blocktri import matvec as _matvec_lanes
from obca_torch.solver.kernels import blocktri_dense as bd
from obca_torch.solver.kernels import blocktri_se as bk
from obca_torch.solver.kernels.blocktri_se import CouplingPattern
from obca_torch.solver.kernels.blocktri_se import matvec_se as _matvec_lanes_se


def make_kkt_solver_se(nw: int, m: int, factor_dtype, residual_dtype,
                       rows, cols):
    """Build ``solve(K, ev, reg, rhs) -> (d, lin_res)``.

    ``nw`` (the primal block size) is kept for parity with the JAX
    signature; the factor pivots by magnitude and does not need it.
    K [B, S, nz, nz] the true (Ruiz-scaled, UNregularized) blocks,
    ev [B, S-1, nnz] the coupling values at (rows, cols), reg [B, nz]
    the +/- factor regularization (applied by the factor itself), rhs
    [B, S, nz].  Returns the GCR solution against the true system and
    the per-lane inf-norm of its final residual.
    """
    pairs = {(int(r), int(c)) for r, c in zip(rows, cols)}
    if len(pairs) != len(rows):
        # The kernels and the lane matvec accumulate repeated entries,
        # while a dense E built with last-write-wins would not: refuse
        # the ambiguous pattern (the OBCA pattern is duplicate-free).
        raise ValueError(
            "make_kkt_solver_se: duplicate (row, col) pairs in the "
            "coupling pattern — the dense and structured routes would "
            "disagree")
    pat = CouplingPattern.of(rows, cols)
    fd, rd = factor_dtype, residual_dtype

    def solve(K, ev, reg, rhs):
        dt = K.dtype
        K_f = K.to(fd).contiguous()
        ev_f = ev.to(fd).contiguous()
        Sinv, Wc = bk.factor_se(K_f, ev_f, reg.to(fd).contiguous(), pat)
        if fd == rd:
            # Fast path: forward substitution, then backward substitution
            # fused with the true-system matvec.
            def step_fn(res):
                y = bk.fwd_se(Sinv, ev_f, res.to(fd).contiguous(), pat)
                return bk.bwd_matvec_se(Wc, y, K_f, ev_f, pat)
        else:
            # Mixed precision: p from the factor in its dtype, its matvec
            # against the system in the residual dtype.
            K_r, ev_r = K.to(rd), ev.to(rd)

            def step_fn(res):
                p = bk.solve_se(Sinv, Wc, ev_f, res.to(fd).contiguous(),
                                pat).to(rd)
                return p, _matvec_lanes_se(K_r, ev_r, pat, p)

        x, lin = _gcr_batched(step_fn, rhs, m, rd)
        return x.to(dt), lin.to(dt)

    return solve


def make_kkt_solver(nw: int, m: int, factor_dtype, residual_dtype):
    """Build ``solve(K, E, reg, rhs) -> (d, lin_res)`` with dense
    coupling blocks.

    ``nw`` is kept for parity with the JAX signature (the factor pivots
    by magnitude).  K [B, S, nz, nz] and E [B, S-1, nz, nz] are the true
    (Ruiz-scaled) system; reg [B, nz] the +/- factor regularization,
    added to each diagonal block before factoring; rhs [B, S, nz].
    Returns the GCR solution against the true system and the per-lane
    inf-norm of its final residual.
    """
    fd, rd = factor_dtype, residual_dtype

    def solve(K, E, reg, rhs):
        dt = K.dtype
        d = torch.arange(K.shape[-1], device=K.device)
        K_reg = K.clone()
        K_reg[:, :, d, d] += reg[:, None, :]
        E_f = E.to(fd).contiguous()
        Sinv, W = bd.factor_dense(K_reg.to(fd).contiguous(), E_f)
        K_r, E_r = K.to(rd), E.to(rd)

        def step_fn(res):
            p = bd.solve_dense(Sinv, W, E_f, res.to(fd).contiguous()).to(rd)
            return p, _matvec_lanes(K_r, E_r, p)

        x, lin = _gcr_batched(step_fn, rhs, m, rd)
        return x.to(dt), lin.to(dt)

    return solve
