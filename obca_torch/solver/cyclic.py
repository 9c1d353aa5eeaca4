"""Block cyclic reduction of the block-tridiagonal KKT system, batched.

Port of ``obca_tpu.solver.cyclic``.  ``blocktri.factor`` and the
kernels eliminate stages one after another: O(S) depth.  Cyclic
reduction eliminates every odd stage at once (batched products over
S/2 stages), halving the system at each level: O(log2 S) depth for
about twice the operations.  Quasidefiniteness carries from level to
level (a Schur complement of a symmetric quasidefinite matrix keeps its
sign pattern), so the same pivot-free, primal-first ``blocktri.qd_inv``
serves every level.  Padding stages are decoupled (E = 0) +-I blocks, so
the solution on the real stages is unchanged.

Level update, eliminating odd stage j = 2k+1 (E_i couples (i, i+1)):

    K'_k = K_{2k} - E_{2k} K_{2k+1}^{-1} E_{2k}'
                  - E_{2k-1}' K_{2k-1}^{-1} E_{2k-1}
    E'_k = - E_{2k} K_{2k+1}^{-1} E_{2k+1}
    r'_k = r_{2k} - E_{2k} K_{2k+1}^{-1} r_{2k+1}
                  - E_{2k-1}' K_{2k-1}^{-1} r_{2k-1}

and back-substitution x_{2k+1} = K_{2k+1}^{-1} (r_{2k+1} - E_{2k}' x_{2k}
- E_{2k+1} x_{2k+2}).  Shapes carry a leading batch axis B: K
[B, S, nz, nz], E [B, S-1, nz, nz], r [B, S, nz].  The even/odd split
is a reshape of the (power-of-two) stage axis, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from obca_torch.solver.blocktri import _mv, qd_inv


class CRLevel(NamedTuple):
    """One level's elimination data, each [B, n_odd, nz, nz]: the
    inverses of the eliminated odd diagonals, and the blocks T[2k, 2k+1]
    (left coupling of each eliminated stage) and T[2k+1, 2k+2] (right
    coupling; zero where the stage has no right neighbour)."""

    odd_inv: torch.Tensor
    E_lo: torch.Tensor
    E_hi: torch.Tensor


class CRFactor(NamedTuple):
    levels: tuple            # tuple[CRLevel, ...], coarsening order
    root_inv: torch.Tensor   # [B, nz, nz] inverse of the 1-stage system


def _pad_to_pow2(K, E, nw: int):
    """Pad the stage axis to 2^p stages with decoupled quasidefinite
    identity blocks (+I on the first nw rows, -I after) and E with zero
    blocks.  Returns (K, E, the original S)."""
    B, S, nz, _ = K.shape
    Sp = 1 << max(1, (S - 1).bit_length())
    if Sp == S:
        return K, E, S
    sign = torch.where(torch.arange(nz, device=K.device) < nw, 1.0,
                       -1.0).to(K.dtype)
    pad_blk = torch.diag(sign).expand(B, Sp - S, nz, nz)
    K = torch.cat([K, pad_blk], dim=1)
    E = torch.cat([E, E.new_zeros((B, Sp - 1 - E.shape[1], nz, nz))], dim=1)
    return K, E, S


def factor(K, E, nw: int) -> CRFactor:
    """Cyclic-reduction factorization of K [B, S, nz, nz] (quasidefinite,
    primal-first nw) and E [B, S-1, nz, nz]; reusable across solves."""
    K, E, _ = _pad_to_pow2(K, E, nw)
    B, _, nz, _ = K.shape
    levels = []
    while K.shape[1] > 1:
        S = K.shape[1]
        half = S // 2
        Kp = K.reshape(B, half, 2, nz, nz)
        odd_inv = qd_inv(Kp[:, :, 1], nw)
        # E padded to S blocks (the last odd stage has no right
        # coupling), then split the same way: E_lo[k] = E[2k], E_hi[k] =
        # E[2k+1].
        Ep = torch.cat([E, E.new_zeros((B, S - E.shape[1], nz, nz))],
                       dim=1).reshape(B, half, 2, nz, nz)
        E_lo, E_hi = Ep[:, :, 0], Ep[:, :, 1]
        levels.append(CRLevel(odd_inv=odd_inv, E_lo=E_lo, E_hi=E_hi))

        AoL = odd_inv @ E_lo.transpose(-1, -2)     # K_odd^{-1} E_lo'
        AoR = odd_inv @ E_hi                       # K_odd^{-1} E_hi
        upd_r = E_lo @ AoL                         # from the right odd
        upd_l = E_hi.transpose(-1, -2) @ AoR       # from the left odd
        Knew = Kp[:, :, 0] - upd_r
        Knew = Knew - torch.cat([upd_l.new_zeros((B, 1, nz, nz)),
                                 upd_l[:, :half - 1]], dim=1)
        # T'[2k, 2k+2] = -E_lo[k] K_odd[k]^{-1} E_hi[k].
        K, E = Knew, -(E_lo @ AoR)[:, :half - 1]
    return CRFactor(levels=tuple(levels), root_inv=qd_inv(K[:, 0], nw))


def solve(fac: CRFactor, r):
    """Solve T x = r for r [B, S, nz] given a CR factorization."""
    B, S0, nz = r.shape
    Sp = 2 ** len(fac.levels)
    r = torch.cat([r, r.new_zeros((B, Sp - S0, nz))], dim=1)

    # Reduction: fold the odd right-hand sides into their even
    # neighbours.
    rs = []
    for lev in fac.levels:
        half = lev.odd_inv.shape[1]
        rp = r.reshape(B, half, 2, nz)
        rodd = rp[:, :, 1]
        rs.append(rodd)
        yodd = _mv(lev.odd_inv, rodd)
        upd_r = _mv(lev.E_lo, yodd)
        upd_l = _mv(lev.E_hi.transpose(-1, -2), yodd)
        r = (rp[:, :, 0] - upd_r
             - torch.cat([upd_l.new_zeros((B, 1, nz)), upd_l[:, :half - 1]],
                         dim=1))

    x = _mv(fac.root_inv, r[:, 0])[:, None]                  # [B, 1, nz]

    # Back-substitution: recover the odd unknowns level by level.
    for lev, rodd in zip(reversed(fac.levels), reversed(rs)):
        half = lev.odd_inv.shape[1]
        x_right = torch.cat(
            [x[:, 1:], x.new_zeros((B, half - (x.shape[1] - 1), nz))],
            dim=1)[:, :half]
        rhs = (rodd - _mv(lev.E_lo.transpose(-1, -2), x[:, :half])
               - _mv(lev.E_hi, x_right))
        x_odd = _mv(lev.odd_inv, rhs)
        x = torch.stack([x[:, :half], x_odd], dim=2).reshape(B, 2 * half, nz)
    return x[:, :S0]
