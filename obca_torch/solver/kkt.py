"""KKT linear-system solver for the batched IPM.

Port of ``obca_tpu.solver.kkt.make_kkt_solver_se``.  The JAX package
dispatches per scenario (XLA) or, under ``vmap`` on a TPU, to the
batch-in-lanes Pallas kernels.  The port always holds the batch, so
there is one route: the structured-coupling kernels of
``obca_torch.solver.kernels.blocktri_se`` — hand-written CUDA on a CUDA
tensor, their plain PyTorch versions on a CPU tensor — with GCR(m)
refinement against the true (unregularized) system.  Layout stays
batch-major [B, S, nz, nz]; the TPU's transposes and (8, 128) padding
are not needed.
"""

from __future__ import annotations


from obca_torch.solver.blocktri import gcr as _gcr_batched
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
        if fd != rd and K.is_cuda:
            raise NotImplementedError(
                "mixed precision (factor dtype != residual dtype) needs "
                "the solve_batched_se kernel, not ported yet (ROADMAP "
                "queue B item 1)")
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
            # Mixed precision (CPU only): p from the factor's dtype, its
            # matvec against the system in the residual dtype.
            K_r, ev_r = K.to(rd), ev.to(rd)

            def step_fn(res):
                y = bk.fwd_se(Sinv, ev_f, res.to(fd), pat)
                p, _ = bk.bwd_matvec_se(Wc, y, K_f, ev_f, pat)
                p = p.to(rd)
                return p, _matvec_lanes_se(K_r, ev_r, pat, p)

        x, lin = _gcr_batched(step_fn, rhs, m, rd)
        return x.to(dt), lin.to(dt)

    return solve
