"""Trajectory figures (matplotlib, on the host; reports and debugging).

Port of ``obca_tpu.viz``: obstacles, start and goal, the solved path,
the ego rectangle swept along the horizon and the control profiles, as
a PNG or a PNG frame sequence.  Everything is drawn from numpy copies:
tensors are accepted on either device.  matplotlib is imported when a
figure is drawn, with the Agg backend, never when this module or the
package is imported.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(a):
    """A host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ego_corners(x, ego_g):
    """Corners [4, 2] of the ego rectangle at state x = (X, Y, psi, ...);
    ego_g = (front, rear, half_w, half_w) in the rear-axle body frame."""
    x, ego_g = _np(x), _np(ego_g)
    X, Y, psi = float(x[0]), float(x[1]), float(x[2])
    front, rear, hw = float(ego_g[0]), float(ego_g[1]), float(ego_g[2])
    body = np.array([[front, hw], [front, -hw], [-rear, -hw], [-rear, hw]])
    c, s = np.cos(psi), np.sin(psi)
    R = np.array([[c, -s], [s, c]])
    return body @ R.T + np.array([X, Y])


def _draw_obstacles(ax, spec):
    verts = _np(spec.obstacles.vertices)
    omask = _np(spec.obstacles.obs_mask)
    fmask = _np(spec.obstacles.face_mask)
    for m in range(verts.shape[0]):
        if omask[m] <= 0:
            continue
        poly = verts[m, :int(fmask[m].sum())]
        ax.fill(poly[:, 0], poly[:, 1], color="0.55", zorder=1)
        ax.plot(np.r_[poly[:, 0], poly[0, 0]], np.r_[poly[:, 1], poly[0, 1]],
                color="0.25", lw=1.0, zorder=2)


def _scene_limits(ax, spec):
    lo, hi = _np(spec.xy_lo), _np(spec.xy_hi)
    ax.set_xlim(lo[0] - 2.5, hi[0] + 2.5)
    ax.set_ylim(lo[1] - 2.5, hi[1] + 2.5)
    ax.set_aspect("equal")


def plot_trajectory(spec, X, U=None, path="trajectory.png", every=4,
                    title=None):
    """Scene plot of one (unbatched) spec: obstacles, the ego box at
    every ``every``-th knot of X [N+1, 4], the path, start and goal;
    with U [N, 2] a (delta, a) profile panel below.  Returns the saved
    figure's path."""
    plt = _require_mpl()
    X = _np(X)
    ego_g = _np(spec.ego_g)
    if U is not None:
        fig, (ax, axu) = plt.subplots(
            2, 1, figsize=(9, 10), gridspec_kw={"height_ratios": [3, 1]})
    else:
        fig, ax = plt.subplots(figsize=(9, 7))
        axu = None

    _draw_obstacles(ax, spec)
    for k in range(0, X.shape[0], max(1, every)):
        box = ego_corners(X[k], ego_g)
        alpha = 0.15 + 0.5 * k / max(1, X.shape[0] - 1)
        ax.fill(box[:, 0], box[:, 1], facecolor="tab:blue", alpha=0.12,
                zorder=3)
        ax.plot(np.r_[box[:, 0], box[0, 0]], np.r_[box[:, 1], box[0, 1]],
                color="tab:blue", lw=0.8, alpha=alpha, zorder=4)
    ax.plot(X[:, 0], X[:, 1], "-", color="tab:red", lw=1.5, zorder=5,
            label="rear-axle path")
    ax.plot(*_np(spec.x0)[:2], "go", ms=8, zorder=6, label="start")
    ax.plot(*_np(spec.xF)[:2], "r*", ms=12, zorder=6, label="goal")
    _scene_limits(ax, spec)
    ax.legend(loc="upper right", fontsize=8)
    if title:
        ax.set_title(title)

    if axu is not None:
        U = _np(U)
        t = np.arange(U.shape[0]) * float(_np(spec.Ts))
        axu.step(t, U[:, 0], where="post", label="steering delta [rad]")
        axu.step(t, U[:, 1], where="post", label="accel a [m/s^2]")
        axu.axhline(0.0, color="0.8", lw=0.5)
        axu.set_xlabel("t [s]")
        axu.legend(fontsize=8)
        axu.grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def save_animation_frames(spec, X, out_dir, stride=1):
    """A PNG frame sequence, one ego box per frame at every
    ``stride``-th knot of X [N+1, 4], into ``out_dir``.  Returns the
    frames' paths."""
    plt = _require_mpl()
    os.makedirs(out_dir, exist_ok=True)
    X = _np(X)
    ego_g = _np(spec.ego_g)
    paths = []
    for i, k in enumerate(range(0, X.shape[0], max(1, stride))):
        fig, ax = plt.subplots(figsize=(8, 6))
        _draw_obstacles(ax, spec)
        ax.plot(X[:k + 1, 0], X[:k + 1, 1], "-", color="tab:red", lw=1.2)
        box = ego_corners(X[k], ego_g)
        ax.fill(box[:, 0], box[:, 1], facecolor="tab:blue", alpha=0.5)
        _scene_limits(ax, spec)
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths
