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

The structured solver is cut at its factorization (``_KktSolverSE.steps``
yields a :class:`FactorRequest`), so that the IPM can run the work on
either side of each ``factor_se`` call as CUDA graphs while the factor
itself stays one eager call of its wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from obca_torch import trace
from obca_torch.solver.blocktri import gcr as _gcr_batched
from obca_torch.solver.blocktri import matvec as _matvec_lanes
from obca_torch.solver.kernels import blocktri_dense as bd
from obca_torch.solver.kernels import blocktri_se as bk
from obca_torch.solver.kernels.blocktri_se import CouplingPattern
from obca_torch.solver.kernels.blocktri_se import matvec_se as _matvec_lanes_se


class FactorRequest(NamedTuple):
    """A factorization that a solve asks of its caller: the inputs of
    ``factor_se`` in the factor dtype and the coupling pattern."""

    K: torch.Tensor
    ev: torch.Tensor
    reg: torch.Tensor
    pat: CouplingPattern

    def factor(self):
        """(Sinv, Wc): one call of the factor kernel's wrapper."""
        with trace.span("kkt.factor"):
            return bk.factor_se(self.K, self.ev, self.reg, self.pat)

    def outputs(self):
        """Empty tensors shaped as :meth:`factor`'s outputs."""
        B, S, nz, _ = self.K.shape
        return (torch.empty_like(self.K),
                self.K.new_empty((B, S - 1, nz, len(self.pat.ucols))))


def resume(gen, value=None):
    """Send ``value`` to a generator of :class:`FactorRequest`: (False,
    its next request) or, once it returns, (True, its value)."""
    try:
        return False, gen.send(value)
    except StopIteration as stop:
        return True, stop.value


def run(gen):
    """Run a generator of :class:`FactorRequest` to its end, sending each
    request its factorization; returns the generator's value."""
    done, out = resume(gen)
    while not done:
        done, out = resume(gen, out.factor())
    return out


class _KktSolverSE:
    """The solver :func:`make_kkt_solver_se` builds, cut at its
    factorization: :meth:`steps` computes the factor's inputs, yields
    them as a :class:`FactorRequest`, and is sent back (Sinv, Wc) for
    the refinement (forward substitution, backward substitution with its
    matvec, GCR).  Calling the solver runs both halves at once."""

    def __init__(self, pat: CouplingPattern, m: int, factor_dtype,
                 residual_dtype):
        self.pat, self.m = pat, m
        self.fd, self.rd = factor_dtype, residual_dtype

    def steps(self, K, ev, reg, rhs):
        fd, rd, pat = self.fd, self.rd, self.pat
        with trace.span("kkt.solve"):
            dt = K.dtype
            K_f = K.to(fd).contiguous()
            ev_f = ev.to(fd).contiguous()
            Sinv, Wc = yield FactorRequest(K_f, ev_f,
                                           reg.to(fd).contiguous(), pat)
            if fd == rd:
                # Fast path: forward substitution, then backward
                # substitution fused with the true-system matvec.
                def step_fn(res):
                    y = bk.fwd_se(Sinv, ev_f, res.to(fd).contiguous(), pat)
                    return bk.bwd_matvec_se(Wc, y, K_f, ev_f, pat)
            else:
                # Mixed precision: p from the factor in its dtype, its
                # matvec against the system in the residual dtype.
                K_r, ev_r = K.to(rd), ev.to(rd)

                def step_fn(res):
                    p = bk.solve_se(Sinv, Wc, ev_f, res.to(fd).contiguous(),
                                    pat).to(rd)
                    return p, _matvec_lanes_se(K_r, ev_r, pat, p)

            with trace.span("kkt.refine"):
                x, lin = _gcr_batched(step_fn, rhs, self.m, rd)
            return x.to(dt), lin.to(dt)

    def __call__(self, K, ev, reg, rhs):
        return run(self.steps(K, ev, reg, rhs))


def make_kkt_solver_se(nw: int, m: int, factor_dtype, residual_dtype,
                       rows, cols) -> _KktSolverSE:
    """Build ``solve(K, ev, reg, rhs) -> (d, lin_res)`` with the coupling
    as sparse values (:class:`_KktSolverSE`).

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
    return _KktSolverSE(CouplingPattern.of(rows, cols), m, factor_dtype,
                        residual_dtype)


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
        with trace.span("kkt.solve"):
            dt = K.dtype
            d = torch.arange(K.shape[-1], device=K.device)
            K_reg = K.clone()
            K_reg[:, :, d, d] += reg[:, None, :]
            E_f = E.to(fd).contiguous()
            with trace.span("kkt.factor"):
                Sinv, W = bd.factor_dense(K_reg.to(fd).contiguous(), E_f)
            K_r, E_r = K.to(rd), E.to(rd)

            def step_fn(res):
                p = bd.solve_dense(Sinv, W, E_f,
                                   res.to(fd).contiguous()).to(rd)
                return p, _matvec_lanes(K_r, E_r, p)

            with trace.span("kkt.refine"):
                x, lin = _gcr_batched(step_fn, rhs, m, rd)
            return x.to(dt), lin.to(dt)

    return solve
