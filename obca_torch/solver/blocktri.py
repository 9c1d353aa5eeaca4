"""Block-tridiagonal quasidefinite KKT factorization and solve (plain
linear-algebra reference, batched).

Port of ``obca_tpu.solver.blocktri`` with a leading batch axis B:

    T = [ K_0  E_0            ]
        [ E_0' K_1  E_1       ]
        [      E_1' K_2  ...  ]

Forward elimination S_0 = K_0, S_k = K_k - E_{k-1}' S_{k-1}^{-1} E_{k-1};
explicit Schur-complement inverses; fwd/bwd substitution; GCR(m)
refinement against the true system.  The hot path does not come here
(it runs the structured-coupling kernels of
``obca_torch.solver.kernels``); this dense-coupling twin of the JAX
module is the reference those kernels are held against in the tests,
and with the LU inverse (``nw=None``) it is the plain version of the
dense-coupling kernels (``kernels.blocktri_dense``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BlockTriFactor(NamedTuple):
    Sinv: torch.Tensor  # [B, S, nz, nz] inverses of the Schur complements
    W: torch.Tensor     # [B, S-1, nz, nz] W_k = S_{k-1}^{-1} E_{k-1}
    E: torch.Tensor     # [B, S-1, nz, nz] the off-diagonal blocks


def spd_inv(A):
    """Explicit inverse of symmetric blocks [..., n, n] by recursive 2x2
    block Schur complements (pivot-free, natural order).  It is meant
    for positive-definite blocks, but like the JAX package's scheme it
    does not check: the IPM's primal blocks are indefinite at times
    (nonconvex Hessian), and the factor is then still a usable
    preconditioner for GCR, so a Cholesky that refuses them is no
    substitute."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        a = A[..., 0, 0]
        b = A[..., 0, 1]
        d = A[..., 1, 1]
        det = a * d - b * b
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-b, a], -1)], -2)
        return inv / det[..., None, None]
    k = n // 2
    A11 = A[..., :k, :k]
    A12 = A[..., :k, k:]
    A22 = A[..., k:, k:]
    I11 = spd_inv(A11)
    B12 = I11 @ A12
    S = A22 - A12.transpose(-1, -2) @ B12
    IS = spd_inv(S)
    off = -B12 @ IS
    top = I11 + B12 @ IS @ B12.transpose(-1, -2)
    return torch.cat(
        [torch.cat([top, off], dim=-1),
         torch.cat([off.transpose(-1, -2), IS], dim=-1)], dim=-2)


def qd_inv(S, nw: int):
    """Explicit inverse of symmetric quasidefinite blocks
    S = [[A, B], [B', D]] (A nw x nw positive definite, D negative
    definite).  The primal block A is eliminated first: after Ruiz
    equilibration the dual Schur complement D - B'A^{-1}B is O(1),
    whereas the reverse order forms A + B(-D)^{-1}B' ~ J'J/delta with
    condition ~1e8, which breaks an f32 factorization at small mu."""
    A = S[..., :nw, :nw]
    B = S[..., :nw, nw:]
    D = S[..., nw:, nw:]
    Ainv = spd_inv(A)
    AB = Ainv @ B
    Sd = D - B.transpose(-1, -2) @ AB
    Sdinv = -spd_inv(-Sd)
    X12 = -AB @ Sdinv
    X11 = Ainv - X12 @ AB.transpose(-1, -2)
    return torch.cat(
        [torch.cat([X11, X12], dim=-1),
         torch.cat([X12.transpose(-1, -2), Sdinv], dim=-1)], dim=-2)


def factor(K, E, nw: int | None = None) -> BlockTriFactor:
    """Factor with diagonal blocks K [B, S, nz, nz] and upper
    off-diagonal blocks E [B, S-1, nz, nz].  ``nw`` is the size of the
    positive (primal) part of each quasidefinite block; None uses the
    dense LU inverse."""
    inv = (lambda M: qd_inv(M, nw)) if nw is not None else torch.linalg.inv
    Sinv = [inv(K[:, 0])]
    Ws = []
    for k in range(1, K.shape[1]):
        W_k = Sinv[-1] @ E[:, k - 1]
        S_k = K[:, k] - E[:, k - 1].transpose(-1, -2) @ W_k
        Sinv.append(inv(S_k))
        Ws.append(W_k)
    W = torch.stack(Ws, 1) if Ws else E.new_empty(E.shape)  # S = 1: none
    return BlockTriFactor(Sinv=torch.stack(Sinv, 1), W=W, E=E)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def fwd_subst(Sinv, E, r):
    """Forward substitution y_k = Sinv_k (r_k - E'_{k-1} y_{k-1})."""
    ys = [_mv(Sinv[:, 0], r[:, 0])]
    for k in range(1, r.shape[1]):
        yhat = r[:, k] - _mv(E[:, k - 1].transpose(-1, -2), ys[-1])
        ys.append(_mv(Sinv[:, k], yhat))
    return torch.stack(ys, 1)


def bwd_subst(W, y):
    """Backward substitution x_{S-1} = y_{S-1}, x_k = y_k - W_k x_{k+1}."""
    xs = [y[:, -1]]
    for k in range(y.shape[1] - 2, -1, -1):
        xs.append(y[:, k] - _mv(W[:, k], xs[-1]))
    return torch.stack(xs[::-1], 1)


def solve(fac: BlockTriFactor, r):
    """Solve T x = r for r [B, S, nz] given a factorization."""
    return bwd_subst(fac.W, fwd_subst(fac.Sinv, fac.E, r))


def matvec(K, E, x):
    """Block-tridiagonal matvec T x for x [B, S, nz]."""
    out = _mv(K, x)
    out[:, :-1] += _mv(E, x[:, 1:])
    out[:, 1:] += _mv(E.transpose(-1, -2), x[:, :-1])
    return out


def gcr(step_fn, rhs, m: int, rd):
    """GCR(m) (truncated Generalized Conjugate Residual) over a batch:
    vectors [B, S, nz], one scalar per lane.  ``step_fn(res) -> (p, Ap)``
    supplies the preconditioned direction and its true-system matvec.
    The residual is monotone in each lane, so a poor low-precision
    preconditioner cannot make it stall the way damped Richardson
    refinement does.  Returns (x in ``rd``, per-lane inf-norm of the
    final residual [B])."""
    tiny = torch.finfo(rd).tiny
    res = rhs.to(rd)
    x = torch.zeros_like(res)
    ps, aps = [], []

    def dot(a, b):
        return torch.sum(a * b, dim=(1, 2), keepdim=True)

    for _ in range(m):
        p, ap = step_fn(res)
        p = p.to(rd)
        ap = ap.to(rd)
        for pj, apj in zip(ps, aps):
            beta = dot(ap, apj)
            p = p - beta * pj
            ap = ap - beta * apj
        nrm = torch.sqrt(dot(ap, ap))
        inv = torch.where(nrm > tiny, 1.0 / torch.clamp(nrm, min=tiny),
                          torch.zeros_like(nrm))
        p = p * inv
        ap = ap * inv
        alpha = dot(res, ap)
        x = x + alpha * p
        res = res - alpha * ap
        ps.append(p)
        aps.append(ap)
    return x, res.abs().amax(dim=(1, 2))


def solve_gcr(K, E, fac: BlockTriFactor, r, m: int = 8,
              residual_dtype=None):
    """GCR(m) on T x = r right-preconditioned by the factor; residual
    arithmetic in ``residual_dtype`` (default r.dtype), preconditioner
    solves in the factor's dtype.  Returns (x in r.dtype, per-lane
    inf-norm of the final true residual [B])."""
    rd = residual_dtype or r.dtype
    fd = fac.Sinv.dtype
    Krd, Erd = K.to(rd), E.to(rd)

    def step(res):
        p = solve(fac, res.to(fd)).to(rd)
        return p, matvec(Krd, Erd, p)

    x, lin = gcr(step, r, m, rd)
    return x.to(r.dtype), lin
