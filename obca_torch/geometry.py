"""Polytope geometry: H-representations, rotations, SAT clearances and
the host-side ego-obstacle distance.

Port of the parts of ``obca_tpu.geometry`` that the solver and the
warm-start planners use.  Tensor functions broadcast over leading pose
axes; the exact distance functions are numpy ground truth for tests.
"""

from __future__ import annotations

import numpy as np
import torch

# Body-frame box normals of the ego; g = (front, rear, half_w, half_w).
EGO_G = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])


def hrep_from_ccw_vertices(verts):
    """Convex polygon vertices [V, 2] (either winding) -> (A, b) with
    A y <= b inside (numpy).  The winding is detected from the signed
    area and the normals flipped for CW input."""
    verts = np.asarray(verts, float)
    q = np.roll(verts, -1, axis=0)
    d = q - verts
    area2 = (verts[:, 0] * q[:, 1] - q[:, 0] * verts[:, 1]).sum()
    sgn = 1.0 if area2 >= 0 else -1.0
    n = np.stack([d[:, 1], -d[:, 0]], axis=-1) * sgn
    n = n / np.sqrt((n ** 2).sum(axis=-1, keepdims=True))
    return n, (n * verts).sum(axis=-1)


def rotation(psi):
    """Rotation matrix R(psi) (world_from_body), psi.shape + (2, 2)."""
    c, s = torch.cos(psi), torch.sin(psi)
    return torch.stack(
        [torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def ego_clearance_exact(pose, ego_g, obstacles):
    """Conservative SAT clearance of the ego rectangle at poses
    ``pose`` [..., >=3] vs every obstacle of one (unbatched) obstacle
    set: [..., M] gaps (negative = collision; padded obstacles +inf).
    Padded faces' axes are replaced by face 0 (a zero axis would report
    gap 0 and win the max for overlapping polygons)."""
    dt = pose.dtype
    front, rear, wl, wr = ego_g[0], ego_g[1], ego_g[2], ego_g[3]
    corners = torch.stack([
        torch.stack([front, wl]), torch.stack([front, -wr]),
        torch.stack([-rear, -wr]), torch.stack([-rear, wl])])   # [4, 2]
    R = rotation(pose[..., 2])                                  # [..., 2, 2]
    t = pose[..., :2]
    ego_pts = corners @ R.transpose(-1, -2) + t[..., None, :]  # [..., 4, 2]
    G = torch.as_tensor(EGO_G, dtype=dt, device=pose.device)
    ego_axes = G @ R.transpose(-1, -2)                         # [..., 4, 2]
    A = obstacles.A                                            # [M, V, 2]
    fm = obstacles.face_mask
    axes_o = torch.where(fm[..., None] > 0, A, A[:, :1, :])    # [M, V, 2]
    verts = obstacles.vertices                                 # [M, V, 2]
    M = A.shape[0]
    lead = pose.shape[:-1]
    axes = torch.cat([
        ego_axes[..., None, :, :].expand(lead + (M, 4, 2)),
        axes_o.expand(lead + axes_o.shape)], dim=-2)           # [..., M, a, 2]
    projP = torch.einsum("...kd,...mad->...mka", ego_pts, axes)
    projQ = torch.einsum("mvd,...mad->...mva", verts, axes)
    gap1 = projQ.amin(-2) - projP.amax(-2)
    gap2 = projP.amin(-2) - projQ.amax(-2)
    gaps = torch.maximum(gap1, gap2).amax(-1)                  # [..., M]
    return torch.where(obstacles.obs_mask > 0, gaps,
                       torch.full_like(gaps, float("inf")))


def ego_clearance_flat(px, py, h, ego_g, obstacles):
    """Batched conservative SAT clearance for flat pose arrays px/py/h
    [n] vs one obstacle set: [n] min-over-obstacles gap.  Same axis set
    and min/max order as ``obca_tpu.geometry.ego_clearance_flat``."""
    c, s = torch.cos(h), torch.sin(h)
    front, rear, wl, wr = ego_g[0], ego_g[1], ego_g[2], ego_g[3]
    body = [(front, wl), (front, -wr), (-rear, -wr), (-rear, wl)]
    ego_pts = [(px + c * bx - s * by, py + s * bx + c * by)
               for bx, by in body]
    ego_axes = [(c, s), (-s, c)]
    M, V = obstacles.num_obs, obstacles.num_faces
    A, verts = obstacles.A, obstacles.vertices
    fmask, omask = obstacles.face_mask, obstacles.obs_mask
    result = torch.full_like(px, float("inf"))
    for m in range(M):
        obs_pts = [(verts[m, v, 0], verts[m, v, 1]) for v in range(V)]

        def axis_gap(ax, ay):
            pe = [ax * x + ay * y for x, y in ego_pts]
            po = [ax * ox + ay * oy for ox, oy in obs_pts]
            emin = emax = pe[0]
            for p in pe[1:]:
                emin = torch.minimum(emin, p)
                emax = torch.maximum(emax, p)
            omin = omax = po[0]
            for p in po[1:]:
                omin = torch.minimum(omin, p)
                omax = torch.maximum(omax, p)
            return torch.maximum(omin - emax, emin - omax)

        gap_m = None
        for ax, ay in ego_axes:
            g = axis_gap(ax, ay)
            gap_m = g if gap_m is None else torch.maximum(gap_m, g)
        for v in range(V):
            real = fmask[m, v] > 0
            ax = torch.where(real, A[m, v, 0], A[m, 0, 0])
            ay = torch.where(real, A[m, v, 1], A[m, 0, 1])
            gap_m = torch.maximum(gap_m, axis_gap(ax, ay))
        gap_m = torch.where(omask[m] > 0, gap_m,
                            torch.full_like(gap_m, float("inf")))
        result = torch.minimum(result, gap_m)
    return result


# ---------------------------------------------------------------------------
# Host-side exact distances (numpy ground truth for tests).
# ---------------------------------------------------------------------------


def vertices_from_hrep(A, b, face_mask):
    """CCW vertices of an H-rep from `hrep_from_ccw_vertices` (vertex
    i is the intersection of faces i-1 and i)."""
    A = np.asarray(A, float)
    b = np.asarray(b, float)
    idx = np.where(np.asarray(face_mask) > 0)[0]
    A, b = A[idx], b[idx]
    k = len(idx)
    return np.asarray([
        np.linalg.solve(np.stack([A[(i - 1) % k], A[i]]),
                        np.array([b[(i - 1) % k], b[i]]))
        for i in range(k)])


def _point_segment_distance(p, a, b):
    ab = b - a
    t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-300), 0.0, 1.0)
    return np.linalg.norm(p - (a + t * ab))


def _polygons_intersect(Pv, Qv):
    for poly in (Pv, Qv):
        k = len(poly)
        for i in range(k):
            e = poly[(i + 1) % k] - poly[i]
            n = np.array([e[1], -e[0]])
            pP, pQ = Pv @ n, Qv @ n
            if pP.max() < pQ.min() or pQ.max() < pP.min():
                return False
    return True


def convex_polygon_distance(Pv, Qv):
    """Exact distance between convex polygons [*, 2]; 0 if they meet."""
    Pv = np.asarray(Pv, float)
    Qv = np.asarray(Qv, float)
    if _polygons_intersect(Pv, Qv):
        return 0.0
    best = np.inf
    for U, V in ((Pv, Qv), (Qv, Pv)):
        k = len(V)
        for p in U:
            for i in range(k):
                best = min(best, _point_segment_distance(
                    p, V[i], V[(i + 1) % k]))
    return float(best)


def ego_obstacle_distance(state, ego_g, obs_A, obs_b, face_mask):
    """Geometric distance between the ego rectangle at ``state`` and
    one obstacle polytope (host-side ground truth for the dual
    reformulation)."""
    state = np.asarray(state, float)
    front, rear, wl, wr = np.asarray(ego_g, float)
    c, s = np.cos(state[2]), np.sin(state[2])
    R = np.array([[c, -s], [s, c]])
    corners = np.array(
        [[front, wl], [front, -wr], [-rear, -wr], [-rear, wl]])
    ego_v = corners @ R.T + state[:2]
    return convex_polygon_distance(
        ego_v, vertices_from_hrep(obs_A, obs_b, face_mask))
