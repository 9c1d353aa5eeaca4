"""Plain float64 geometry and the solution check shared by the problem
families.

Everything here is written from the problem's definition, in plain
PyTorch on the CPU.  It imports nothing of the program: the problem data
comes from the configuration file and the traffic, and the program's
outputs (trajectories, multipliers, statuses) are only read to be judged.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def t64(a):
    """A float64 CPU tensor of ``a`` (a tensor on any device, an array
    or a list)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device="cpu", dtype=F64)
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


def halfspaces(vertex_lists, M, V):
    """Outward unit normals and offsets of convex polygons given by
    their vertices in order, face v running from vertex v to v+1, padded
    to (M, V) with zero faces: (A [M, V, 2], b [M, V], face_mask [M, V],
    obs_mask [M], vertices [M, V, 2])."""
    A = np.zeros((M, V, 2))
    b = np.zeros((M, V))
    fmask = np.zeros((M, V))
    omask = np.zeros((M,))
    verts = np.zeros((M, V, 2))
    for m, vl in enumerate(vertex_lists):
        p = np.asarray(vl, float)
        q = np.roll(p, -1, axis=0)
        d = q - p
        area2 = (p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]).sum()
        n = np.stack([d[:, 1], -d[:, 0]], -1) * (1.0 if area2 >= 0 else -1.0)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        k = len(p)
        A[m, :k] = n
        b[m, :k] = (n * p).sum(-1)
        fmask[m, :k] = 1.0
        omask[m] = 1.0
        verts[m, :k] = p
        verts[m, k:] = p[-1]
    return tuple(torch.as_tensor(a, dtype=F64)
                 for a in (A, b, fmask, omask, verts))


def _point_segment(p, a, b):
    """Distance of points p [..., 2] to segments a-b [..., 2]."""
    ab = b - a
    t = ((p - a) * ab).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-300)
    t = t.clamp(0.0, 1.0)
    return (p - (a + t[..., None] * ab)).norm(dim=-1)


def polygon_distance(P, Q):
    """Euclidean distance between convex polygons P [..., p, 2] and Q
    [..., q, 2] (vertices in order), negative inside: where no edge
    normal of either separates them, the largest separating-axis gap
    (at most 0, minus the least penetration along those axes)."""
    def normals(R):
        e = torch.roll(R, -1, dims=-2) - R
        n = torch.stack([e[..., 1], -e[..., 0]], -1)
        return n / n.norm(dim=-1, keepdim=True).clamp(min=1e-300)

    axes = torch.cat([normals(P), normals(Q)], dim=-2)      # [..., a, 2]
    pp = torch.einsum("...ad,...pd->...ap", axes, P)
    pq = torch.einsum("...ad,...qd->...aq", axes, Q)
    gap = torch.maximum(pq.amin(-1) - pp.amax(-1), pp.amin(-1) - pq.amax(-1))
    sat = gap.amax(-1)

    def vert_to_edges(R, S):
        a = S[..., None, :, :]
        b = torch.roll(S, -1, dims=-2)[..., None, :, :]
        return _point_segment(R[..., :, None, :], a, b).amin(dim=(-1, -2))

    d = torch.minimum(vert_to_edges(P, Q), vert_to_edges(Q, P))
    return torch.where(sat > 0, d, sat)


def point_polygon_distance(p, Q):
    """Signed distance of points p [..., 2] to convex polygons Q
    [..., q, 2]: the distance outside, minus the depth inside."""
    e = torch.roll(Q, -1, dims=-2) - Q
    n = torch.stack([e[..., 1], -e[..., 0]], -1)
    n = n / n.norm(dim=-1, keepdim=True)
    # Orient the normals outward (either winding).
    centre = Q.mean(-2, keepdim=True)
    flip = ((Q - centre) * n).sum(-1, keepdim=True) < 0
    n = torch.where(flip, -n, n)
    face = ((p[..., None, :] - Q) * n).sum(-1)                # [..., q]
    inside = face.amax(-1)
    out = _point_segment(p[..., None, :], Q,
                         torch.roll(Q, -1, dims=-2)).amin(-1)
    return torch.where(inside > 0, out, inside)


def kkt_readings(fam, prob, W, nu, zL, zU):
    """Per-lane readings [L] of a solution against its problem, all in
    float64: ``pri`` the largest violation of an equality (|c|), an
    inequality (c < 0) or a bound; ``stat`` the largest stationarity
    residual of the Lagrangian in the primal columns (states, inputs,
    time scaling), scaled as the barrier method's own error is (by the
    mean multiplier size over 100, at least 1); ``comp`` the largest
    complementarity product or multiplier of the wrong sign.

    ``fam`` is a problem-family module of this package (``constraints``,
    ``objective``, ``bounds``, ``PRIMAL``); W [L, N+1, nw], nu [L, N+1,
    nc], zL and zU [L, N+1, nw] are the solver's returned iterate and
    multipliers (inequality rows carry nu = -y, y >= 0)."""
    W, nu, zL, zU = (t64(a) for a in (W, nu, zL, zU))
    active, is_eq = fam.masks(prob)
    lo, hi, has_lo, has_hi = fam.bounds(prob)
    Wv = W.clone().requires_grad_(True)
    c = fam.constraints(prob, Wv)
    lag = fam.objective(prob, Wv) + (nu * active * c).sum()
    (g,) = torch.autograd.grad(lag, Wv)
    c = c.detach()
    eq = is_eq * active
    ineq = (1.0 - is_eq) * active
    lo, hi = lo[:, None], hi[:, None]
    has_lo, has_hi = has_lo[:, None], has_hi[:, None]
    viol = torch.maximum((c.abs() * eq).amax(dim=(1, 2)),
                         (torch.relu(-c) * ineq).amax(dim=(1, 2)))
    viol = torch.maximum(viol, (torch.relu(lo - W) * has_lo).amax(dim=(1, 2)))
    viol = torch.maximum(viol, (torch.relu(W - hi) * has_hi).amax(dim=(1, 2)))
    rw = (g - zL + zU)[..., fam.PRIMAL]
    n_nu, n_z = nu[0].numel(), W[0].numel()
    s_d = ((nu.abs().sum(dim=(1, 2)) + zL.abs().sum(dim=(1, 2))
            + zU.abs().sum(dim=(1, 2))) / (n_nu + 2 * n_z) / 100.0
           ).clamp(min=1.0)
    stat = rw.abs().amax(dim=(1, 2)) / s_d
    y = -nu
    comp = (c * y * ineq).abs().amax(dim=(1, 2))
    comp = torch.maximum(comp, (torch.relu(-y) * ineq).amax(dim=(1, 2)))
    for z, gap, has in ((zL, W - lo, has_lo), (zU, hi - W, has_hi)):
        comp = torch.maximum(comp, (z * gap * has).abs().amax(dim=(1, 2)))
        comp = torch.maximum(comp, (torch.relu(-z) * has).amax(dim=(1, 2)))
    return {"pri": viol, "stat": stat, "comp": comp}
