"""Primal warm start: interpolation and the lattice warm-start pipeline.

Port of ``obca_tpu.warmstart.geometric``.  Functions take a batched
spec (leading B on every leaf) or an unbatched one (the result then has
no batch axis).
"""

from __future__ import annotations

import torch

from obca_torch import nlp, trace
from obca_torch import spec as spec_mod
from obca_torch._util import linspace
from obca_torch.warmstart import dual_ws


def _batched(spec):
    """(batched spec, True if the input was a single instance)."""
    if spec.x0.dim() == 1:
        return spec_mod.stack([spec]), True
    return spec, False


def interpolated_states(spec, dtype=None):
    """Linear state interpolation x0 -> xF over the horizon
    [B, N+1, 4] (batched spec)."""
    dt = dtype or spec.x0.dtype
    alpha = linspace(0.0, 1.0, spec.N + 1, dt, spec.x0.device)[:, None]
    return ((1.0 - alpha) * spec.x0[:, None, :].to(dt)
            + alpha * spec.xF[:, None, :].to(dt))


def warm_start(spec, X=None, U=None, tau=None, dtype=None,
               dual_eps: float = 1e-2):
    """Packed warm-start trajectories W [B, N+1, nw]: states X (default:
    interpolation), inputs U (default 0), tau (default 1) and the
    geometric dual warm start."""
    spec, single = _batched(spec)
    if single and X is not None:
        X = X[None]
        U = None if U is None else U[None]
    L = nlp.layout_of(spec)
    dt = dtype or spec.x0.dtype
    if X is None:
        X = interpolated_states(spec, dt)
    B = spec.x0.shape[0]
    W = torch.zeros((B, L.N + 1, L.nw), dtype=dt, device=spec.x0.device)
    W[..., L.sl_x] = X.to(dt)
    if U is not None:
        W[:, :L.N, L.sl_u] = U.to(dt)
    W[..., L.i_tau] = 1.0 if tau is None else tau
    W = dual_ws.apply_dual_ws(spec_mod.cast_floats(spec, dt), W,
                              eps=dual_eps)
    return W[0] if single else W


def lattice_warm_start(spec, dtype=None, dual_eps=1e-2, cfg=None,
                       field=None):
    """Collision-aware warm start: SE(2) lattice plan + staging-goal
    expansion + velocity profile + geometric duals, with the
    Reeds-Shepp warm start where the lattice does not reach the goal.

    ``field``: a precomputed ``lattice.PlanField`` shared by every lane
    (it depends only on obstacles and goal).  Without one, each lane
    gets its own field from its own geometry.
    """
    from obca_torch.warmstart import lattice as lattice_mod
    from obca_torch.warmstart import velosmooth

    spec, single = _batched(spec)
    if field is None:
        lanes = []
        for i in range(spec.x0.shape[0]):
            sp = spec_mod.take(spec, slice(i, i + 1))
            lane = spec_mod.take(sp, 0)
            lcfg = cfg or lattice_mod.default_config(lane)
            lanes.append(lattice_warm_start(
                sp, dtype=dtype, dual_eps=dual_eps, cfg=lcfg,
                field=lattice_mod.plan_field(lane, lcfg)))
        W = torch.cat(lanes, dim=0)
        return W[0] if single else W
    with trace.span("warmstart.lattice"):
        lcfg = cfg or lattice_mod.LatticeConfig()
        poses, dirs, seg_len, _n_valid, reached = lattice_mod.extract(
            spec, field, lcfg)
        X_lat, U_lat = velosmooth.polyline_time_sampled(spec, poses, dirs,
                                                        seg_len)
        X_rs, U_rs = velosmooth.rs_time_sampled(spec)
        r = reached[:, None, None]
        X = torch.where(r, X_lat, X_rs)
        U = torch.where(r, U_lat, U_rs)
        W = warm_start(spec, X=X, U=U, dtype=dtype, dual_eps=dual_eps)
    return W[0] if single else W


def layout_fields(layouts, lcfg):
    """One ``lattice.PlanField`` per layout of a stacked ``layouts``
    batch, on the static grid of ``lcfg``."""
    from obca_torch.warmstart import lattice as lattice_mod

    return [lattice_mod.plan_field(spec_mod.take(layouts, g), lcfg)
            for g in range(layouts.x0.shape[0])]


def grouped_lattice_warm_start(specs, layouts, lcfg, dtype=None,
                               dual_eps=1e-2, fields=None):
    """Warm starts of a grouped randomized-obstacle batch.

    ``specs`` [B] is ``n_layouts`` contiguous groups of B / n_layouts
    lanes that share one obstacle layout; ``layouts`` [n_layouts] holds
    one spec per layout (see ``spec.randomized_reverse_parking_specs``).
    One ``PlanField`` per layout (it depends on obstacles, goal and
    bounds, not on the start pose), then the lattice warm start of each
    group's lanes with its field.  ``lcfg`` fixes the static grid (the
    primitive cell offsets); each layout's own bounds place its cells,
    occupancy and goal.  ``fields``: the layouts' fields, if the caller
    computed them already (:func:`layout_fields`).
    """
    if fields is None:
        fields = layout_fields(layouts, lcfg)
    group = specs.x0.shape[0] // len(fields)
    out = []
    for g, field in enumerate(fields):
        lanes = spec_mod.take(specs, slice(g * group, (g + 1) * group))
        out.append(lattice_warm_start(lanes, dtype=dtype, dual_eps=dual_eps,
                                      cfg=lcfg, field=field))
    return torch.cat(out, dim=0)


def rs_warm_start(spec, dtype=None, delta_frac=0.8, dual_eps=1e-2):
    """Reeds-Shepp path + smooth velocity profile + geometric duals: the
    warm start for obstacle-light instances, where the lattice planner
    is not needed."""
    from obca_torch.warmstart import velosmooth

    spec, single = _batched(spec)
    X, U = velosmooth.rs_time_sampled(spec, delta_frac=delta_frac)
    W = warm_start(spec, X=X, U=U, dtype=dtype, dual_eps=dual_eps)
    return W[0] if single else W
