"""Problem and solver specifications as frozen dataclasses of tensors.

Port of ``obca_tpu.spec``.  A :class:`ProblemSpec` whose tensor leaves
carry a leading axis B is a batch of B problems (the JAX package
stacks pytrees and ``vmap``s; the port keeps the stacked form and
every function from ``nlp`` down works on it directly).  Static fields
(horizon, obstacle padding, flags) are plain Python values shared by
the whole batch.

Shapes are static (padded): obstacle and face counts are padded to
(M, V) with explicit masks; padded faces are (A=0, b=0).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from obca_torch import geometry
from obca_torch._util import resolve_device


def map_tensors(fn, obj):
    """Apply ``fn`` to every tensor leaf of a spec / obstacle /
    dual-state dataclass (recursing into nested dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        kw = {f.name: map_tensors(fn, getattr(obj, f.name))
              for f in dataclasses.fields(obj)}
        return dataclasses.replace(obj, **kw)
    return obj


def tensor_leaves(obj):
    """The tensor leaves of ``obj`` in :func:`map_tensors` order."""
    out = []
    map_tensors(lambda t: out.append(t) or t, obj)
    return out


def with_leaves(obj, leaves):
    """``obj`` with its tensor leaves replaced, in order, by ``leaves``
    (the inverse of :func:`tensor_leaves`; for ``torch.func`` transforms,
    which take tensors, not dataclasses)."""
    it = iter(leaves)
    return map_tensors(lambda _t: next(it), obj)


def cast_floats(obj, dtype):
    """Cast the floating-point leaves to ``dtype``."""
    return map_tensors(
        lambda t: t.to(dtype) if t.is_floating_point() else t, obj)


def stack(objs):
    """Stack a list of same-structure dataclasses along a new axis 0."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(objs)
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(o, f.name) for o in objs]
        if isinstance(vals[0], torch.Tensor) or dataclasses.is_dataclass(
                vals[0]):
            kw[f.name] = stack(vals)
        else:
            kw[f.name] = vals[0]
    return dataclasses.replace(first, **kw)


def take(obj, idx):
    """Select lanes ``idx`` (an index tensor or slice) of a batch."""
    return map_tensors(lambda t: t[idx], obj)


@dataclasses.dataclass(frozen=True)
class Obstacles:
    """Padded convex polytope obstacles O_m = {y : A_m y <= b_m}:
    ``A`` [M, V, 2], ``b`` [M, V], ``face_mask`` [M, V] (1 real / 0
    padded), ``obs_mask`` [M], ``center`` [M, 2], ``vertices`` [M, V, 2]
    (padded rows repeat the last vertex).  Padded faces are (A=0, b=0):
    0'y <= 0 is trivially true and contributes nothing to the dual
    OBCA terms."""

    A: torch.Tensor
    b: torch.Tensor
    face_mask: torch.Tensor
    obs_mask: torch.Tensor
    center: torch.Tensor
    vertices: torch.Tensor
    num_obs: int = 0
    num_faces: int = 0


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """One OBCA parking problem (or a batch: leading axis B on every
    tensor leaf).  Fields as in ``obca_tpu.spec.ProblemSpec``."""

    x0: torch.Tensor          # [4]
    xF: torch.Tensor          # [4]
    Ts: torch.Tensor          # []
    wheelbase: torch.Tensor   # []
    ego_g: torch.Tensor       # [4] (front, rear, half_w, half_w)
    obstacles: Obstacles
    u_lo: torch.Tensor        # [2]
    u_hi: torch.Tensor        # [2]
    v_lo: torch.Tensor        # []
    v_hi: torch.Tensor        # []
    xy_lo: torch.Tensor       # [2]
    xy_hi: torch.Tensor       # [2]
    du_max: torch.Tensor      # [2] (< 0 disables the rate bound)
    u_prev: torch.Tensor      # [2]
    d_min: torch.Tensor       # []
    r_u: torch.Tensor         # [2]
    r_du: torch.Tensor        # [2]
    q_time: torch.Tensor      # [2]
    w_reg: torch.Tensor       # []
    dual_ref: torch.Tensor    # [N+1, M*V + 4M]
    tau_lo: torch.Tensor      # []
    tau_hi: torch.Tensor      # []
    N: int = 80
    fix_time: bool = True
    signed: bool = True
    max_obs: int = 4
    max_faces: int = 4


def _f64(v):
    return dataclasses.field(
        default_factory=lambda: torch.tensor(v, dtype=torch.float64))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Interior-point solver configuration; same fields and defaults as
    ``obca_tpu.spec.SolverConfig`` (see its docstring for each knob).
    Tolerances are 0-d float64 tensors; iteration caps, flags and
    dtypes are static."""

    tol: torch.Tensor = _f64(1e-6)
    mu_init: torch.Tensor = _f64(0.1)
    mu_min: torch.Tensor = _f64(1e-7)
    mu_kappa: torch.Tensor = _f64(0.2)
    mu_theta: torch.Tensor = _f64(1.5)
    kappa_eps: torch.Tensor = _f64(10.0)
    tau_ftb: torch.Tensor = _f64(0.995)
    delta_w: torch.Tensor = _f64(1e-8)
    delta_c: torch.Tensor = _f64(1e-8)
    merit_rho: torch.Tensor = _f64(100.0)
    delta_factor: torch.Tensor = _f64(1e-4)
    step_max: torch.Tensor = _f64(5.0)
    max_iter: int = 100
    ls_steps: int = 12
    refine_iters: int = 3
    dtype: Any = torch.float64
    residual_dtype: Any = None
    factor_dtype: Any = None
    dual_init_ls: bool = True
    dual_ls_warm: bool = False
    watchdog: bool = True
    ruiz_iters: int = 3
    ruiz_pow2: bool = False
    ruiz_single_apply: bool = True
    soc: bool = True
    strict_steps: bool = False


def _cfg(**kw) -> SolverConfig:
    tensor_fields = {f.name for f in dataclasses.fields(SolverConfig)
                     if f.type == "torch.Tensor"}
    kw = {k: (torch.as_tensor(v, dtype=torch.float64)
              if k in tensor_fields else v) for k, v in kw.items()}
    return SolverConfig(**kw)


def mixed_solver_config(max_iter: int = 100, tol: float = 1e-6,
                        **overrides) -> SolverConfig:
    """f64 iterate with an f32 factorization recovered by refinement:
    the factor and its substitutions run in f32 (on the card, the
    ``factor_se``, ``fwd_se`` and ``bwd_se`` kernels), GCR and its
    matvec in f64.  The accuracy-grade configuration (SOC on)."""
    kw = dict(dtype=torch.float64, factor_dtype=torch.float32,
              residual_dtype=torch.float64, tol=tol, delta_factor=1e-4,
              refine_iters=4, max_iter=max_iter)
    kw.update(overrides)
    return _cfg(**kw)


def f32_solver_config(max_iter: int = 150, tol: float = 1e-4,
                      **overrides) -> SolverConfig:
    """Single-precision fast path: heavier factor regularization, GCR
    depth 4, 8 line-search points, SOC off, barrier floor 1e-6."""
    kw = dict(dtype=torch.float32, residual_dtype=torch.float32,
              soc=False, tol=tol, mu_min=1e-6, delta_w=1e-7,
              delta_c=1e-7, delta_factor=1e-4, refine_iters=4,
              ls_steps=8, max_iter=max_iter)
    kw.update(overrides)
    return _cfg(**kw)


def parallel_fastpath_config(max_iter: int = 250,
                             **overrides) -> SolverConfig:
    """f32 fast path for the parallel-parking family: SOC on, barrier
    to 1e-7, mu_init 1e-3 (warm-start basin pinning), GCR depth 16,
    four Ruiz sweeps."""
    kw = dict(soc=True, tol=3e-5, mu_min=1e-7, mu_init=1e-3,
              refine_iters=16, ruiz_iters=4, max_iter=max_iter)
    kw.update(overrides)
    return f32_solver_config(**kw)


# ---------------------------------------------------------------------------
# Canonical scenarios (host-side numpy construction, then one transfer).
# ---------------------------------------------------------------------------

def obstacles_from_vertices(vertex_lists, max_obs=None, max_faces=None,
                            dtype=torch.float64,
                            device="cuda") -> Obstacles:
    """CCW vertex lists -> padded halfspace representation.  Padded
    faces are (A = 0, b = 0)."""
    dev = resolve_device(device)
    M = max_obs if max_obs is not None else len(vertex_lists)
    V = max_faces if max_faces is not None else max(
        (len(v) for v in vertex_lists), default=1)
    A = np.zeros((M, V, 2))
    b = np.zeros((M, V))
    fmask = np.zeros((M, V))
    omask = np.zeros((M,))
    center = np.zeros((M, 2))
    vertices = np.zeros((M, V, 2))
    for m, verts in enumerate(vertex_lists):
        va = np.asarray(verts, float)
        Am, bm = geometry.hrep_from_ccw_vertices(va)
        k = Am.shape[0]
        A[m, :k] = Am
        b[m, :k] = bm
        fmask[m, :k] = 1.0
        omask[m] = 1.0
        center[m] = va.mean(axis=0)
        vertices[m, :k] = va
        vertices[m, k:] = va[-1]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return Obstacles(A=t(A), b=t(b), face_mask=t(fmask),
                     obs_mask=t(omask), center=t(center),
                     vertices=t(vertices), num_obs=M, num_faces=V)


def _base_spec(x0, xF, obstacles, *, N, Ts, xy_lo, xy_hi, d_min, fix_time,
               signed, dtype, device) -> ProblemSpec:
    dev = obstacles.A.device

    def f(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    n_dual = obstacles.num_obs * obstacles.num_faces + 4 * obstacles.num_obs
    return ProblemSpec(
        dual_ref=torch.zeros((N + 1, n_dual), dtype=dtype, device=dev),
        x0=f(x0), xF=f(xF), Ts=f(Ts), wheelbase=f(2.7),
        ego_g=f([3.7, 1.0, 1.0, 1.0]), obstacles=obstacles,
        u_lo=f([-0.6, -0.4]), u_hi=f([0.6, 0.4]),
        v_lo=f(-1.0), v_hi=f(2.0), xy_lo=f(xy_lo), xy_hi=f(xy_hi),
        du_max=f([0.6, -1.0]), u_prev=f([0.0, 0.0]), d_min=f(d_min),
        r_u=f([0.5, 0.5]), r_du=f([0.1, 0.1]), q_time=f([0.5, 1.0]),
        w_reg=f(1e-2), tau_lo=f(0.3), tau_hi=f(2.5),
        N=N, fix_time=fix_time, signed=signed,
        max_obs=obstacles.num_obs, max_faces=obstacles.num_faces,
    )


def reverse_parking_spec(N=80, Ts=0.3, fix_time=True, signed=True,
                         d_min=0.05, max_obs=None, max_faces=None,
                         dtype=torch.float64,
                         device="cuda") -> ProblemSpec:
    """Reverse (back-in) parking between two blocks plus an upper wall:
    a 2.6 m slot; the car starts on the road facing +x and backs into
    the slot heading -y."""
    slot_half = 1.3
    obs = obstacles_from_vertices(
        [
            [(-20.0, 5.0), (-slot_half, 5.0), (-slot_half, -5.0),
             (-20.0, -5.0)],
            [(slot_half, 5.0), (20.0, 5.0), (20.0, -5.0), (slot_half, -5.0)],
            [(-20.0, 15.0), (20.0, 15.0), (20.0, 11.0), (-20.0, 11.0)],
        ],
        max_obs=max_obs, max_faces=max_faces, dtype=dtype, device=device,
    )
    x0 = [-6.0, 9.0, 0.0, 0.0]
    xF = [0.0, 1.3, np.pi / 2.0, 0.0]
    return _base_spec(
        x0, xF, obs, N=N, Ts=Ts, xy_lo=[-15.0, 1.0], xy_hi=[15.0, 10.0],
        d_min=d_min, fix_time=fix_time, signed=signed, dtype=dtype,
        device=device,
    )


def parallel_parking_spec(N=80, Ts=0.3, fix_time=True, signed=True,
                          d_min=0.05, max_obs=None, max_faces=None,
                          dtype=torch.float64,
                          device="cuda") -> ProblemSpec:
    """Parallel parking into an 8 m curbside slot between two blocks,
    with the curb as a third obstacle; the car starts on the street and
    parks 0.2 m off the curb."""
    obs = obstacles_from_vertices(
        [
            [(-15.0, 5.0), (-4.0, 5.0), (-4.0, 0.0), (-15.0, 0.0)],
            [(4.0, 5.0), (15.0, 5.0), (15.0, 0.0), (4.0, 0.0)],
            [(-15.0, 2.5), (15.0, 2.5), (15.0, 0.0), (-15.0, 0.0)],
        ],
        max_obs=max_obs, max_faces=max_faces, dtype=dtype, device=device,
    )
    x0 = [-7.0, 7.0, 0.0, 0.0]
    xF = [-1.35, 3.7, 0.0, 0.0]
    return _base_spec(
        x0, xF, obs, N=N, Ts=Ts, xy_lo=[-12.0, 2.6], xy_hi=[12.0, 10.0],
        d_min=d_min, fix_time=fix_time, signed=signed, dtype=dtype,
        device=device,
    )


# ---------------------------------------------------------------------------
# Randomized-obstacle families.  Built on the CPU with numpy from one
# ``np.random.default_rng(seed)`` in the JAX package's draw order (a seed
# gives its specs bit for bit in float64), then moved to the device once
# per leaf.
# ---------------------------------------------------------------------------

def _np_sat_clearance(px, py, h, ego_g, verts_list):
    """Exact SAT clearance (numpy, on the host) of the ego rectangle at
    poses (px, py, h) [n] against convex polygons given as CCW vertex
    arrays: the smallest separation gap over the obstacles (negative =
    overlap).  The numpy twin of ``geometry.ego_clearance_flat``, for
    building specs without device work."""
    px, py, h = (np.asarray(a, np.float64) for a in (px, py, h))
    c, s = np.cos(h), np.sin(h)
    front, rear, wl, wr = (float(v) for v in ego_g)
    body = np.asarray(
        [(front, wl), (front, -wr), (-rear, -wr), (-rear, wl)])
    ex = px[:, None] + c[:, None] * body[:, 0] - s[:, None] * body[:, 1]
    ey = py[:, None] + s[:, None] * body[:, 0] + c[:, None] * body[:, 1]
    P = np.stack([ex, ey], axis=-1)                     # [n, 4, 2]
    axes_ego = np.stack(
        [np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)
    out = np.full(px.shape, np.inf)
    for V in verts_list:
        V = np.asarray(V, np.float64)                   # [v, 2]
        edges = np.roll(V, -1, axis=0) - V
        nrm = np.stack([edges[:, 1], -edges[:, 0]], -1)
        nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        ax = np.concatenate(
            [axes_ego,
             np.broadcast_to(nrm[None], (len(px),) + nrm.shape)],
            axis=1)                                     # [n, a, 2]
        projP = np.einsum("nkd,nad->nka", P, ax)
        projQ = np.einsum("vd,nad->nva", V, ax)
        gap1 = projQ.min(1) - projP.max(1)
        gap2 = projP.min(1) - projQ.max(1)
        out = np.minimum(out, np.maximum(gap1, gap2).max(-1))
    return out


def _grouped_batch(rng, layout_list, layout_verts, base, B, n_layouts,
                   pose_spread, psi_spread, dtype, device):
    """(specs, layouts, group) from per-layout specs built on the CPU:
    each layout serves a contiguous group of B / n_layouts lanes, whose
    start poses are drawn from ``rng`` and rejection-sampled (40 rounds,
    then the layout's base pose) to clear every obstacle by at least
    d_min + 0.02 (stage 0 is pinned at x0)."""
    layouts = stack(layout_list)
    group = B // n_layouts
    specs = map_tensors(lambda t: t.repeat_interleave(group, dim=0),
                        layouts)
    x0 = np.repeat(layouts.x0.numpy(), group, axis=0)
    dpose = np.zeros((B, 4))
    dpose[:, :2] = rng.uniform(-pose_spread, pose_spread, size=(B, 2))
    dpose[:, 2] = rng.uniform(-psi_spread, psi_spread, size=B)

    ego_g = base.ego_g.double().numpy()
    margin = float(base.d_min) + 0.02
    for li in range(n_layouts):
        sl = np.arange(li * group, (li + 1) * group)
        for _ in range(40):
            cand = x0[sl] + dpose[sl]
            clr = _np_sat_clearance(cand[:, 0], cand[:, 1], cand[:, 2],
                                    ego_g, layout_verts[li])
            bad = np.flatnonzero(clr < margin)
            if not bad.size:
                break
            idx = sl[bad]
            dpose[idx, :2] = rng.uniform(-pose_spread, pose_spread,
                                         size=(bad.size, 2))
            dpose[idx, 2] = rng.uniform(-psi_spread, psi_spread,
                                        size=bad.size)
        else:
            cand = x0[sl] + dpose[sl]
            clr = _np_sat_clearance(cand[:, 0], cand[:, 1], cand[:, 2],
                                    ego_g, layout_verts[li])
            dpose[sl[clr < margin]] = 0.0

    specs = dataclasses.replace(
        specs, x0=torch.as_tensor(x0 + dpose, dtype=dtype))
    dev = resolve_device(device)
    return (map_tensors(lambda t: t.to(dev), specs),
            map_tensors(lambda t: t.to(dev), layouts), group)


def randomized_reverse_parking_specs(B, n_layouts=8, seed=0, N=80, Ts=0.3,
                                     pose_spread=0.5, psi_spread=0.15,
                                     vary_topology=False,
                                     dtype=torch.float64, device="cuda"):
    """Reverse-parking batch with randomized start poses and obstacles.

    Per layout: slot half-width 1.25-1.6 m, slot centre +-0.8 m,
    block-top height 4.7-5.3 m, upper-wall depth 10.8-12 m, the goal
    moving with the slot.  With ``vary_topology`` the upper wall may be
    absent, a parked-car box may stand on the right block top, and the
    slot-entrance corners may be bevelled (5-vertex blocks); every
    layout pads to (4 obstacles, 5 faces) with masked rows.  Each of the
    ``n_layouts`` layouts serves a contiguous group of B / n_layouts
    lanes (one lattice ``PlanField`` per layout); start poses are drawn
    per lane.

    Returns ``(specs, layouts, group_size)``: ``specs`` stacked [B],
    ``layouts`` stacked [n_layouts] (their x0 are placeholders), and
    group_size = B // n_layouts.
    """
    if B % n_layouts:
        raise ValueError(f"B={B} must be a multiple of "
                         f"n_layouts={n_layouts}")
    rng = np.random.default_rng(seed)
    mo, mf = (4, 5) if vary_topology else (None, None)
    base = reverse_parking_spec(N=N, Ts=Ts, dtype=dtype, max_obs=mo,
                                max_faces=mf, device="cpu")
    layout_list, layout_verts = [], []
    for _ in range(n_layouts):
        sh = rng.uniform(1.25, 1.6)       # slot half-width
        xc = rng.uniform(-0.8, 0.8)       # slot centre
        yt = rng.uniform(4.7, 5.3)        # block-top height
        yw = rng.uniform(10.8, 12.0)      # upper wall bottom edge
        if vary_topology and rng.random() < 0.5:
            bw, bh = rng.uniform(0.15, 0.45, size=2)
            left = [(-20.0, yt), (xc - sh - bw, yt),
                    (xc - sh, yt - bh), (xc - sh, -5.0), (-20.0, -5.0)]
        else:
            left = [(-20.0, yt), (xc - sh, yt), (xc - sh, -5.0),
                    (-20.0, -5.0)]
        if vary_topology and rng.random() < 0.5:
            bw, bh = rng.uniform(0.15, 0.45, size=2)
            right = [(xc + sh, yt - bh), (xc + sh + bw, yt),
                     (20.0, yt), (20.0, -5.0), (xc + sh, -5.0)]
        else:
            right = [(xc + sh, yt), (20.0, yt), (20.0, -5.0),
                     (xc + sh, -5.0)]
        vlist = [left, right]
        if not vary_topology or rng.random() < 0.75:
            vlist.append([(-20.0, yw + 4.0), (20.0, yw + 4.0),
                          (20.0, yw), (-20.0, yw)])
        if vary_topology and rng.random() < 0.5:
            # Parked-car box on the right block top, clear of the slot.
            x0b = xc + sh + rng.uniform(3.5, 6.0)
            wb, hb = rng.uniform(1.8, 2.4), rng.uniform(1.4, 2.0)
            vlist.append([(x0b, yt + hb), (x0b + wb, yt + hb),
                          (x0b + wb, yt), (x0b, yt)])
        layout_verts.append(vlist)
        obs = obstacles_from_vertices(vlist, max_obs=mo, max_faces=mf,
                                      dtype=dtype, device="cpu")
        # Park flush: the ego front (3.7 m ahead of the rear axle) at the
        # block-top line.
        xF = torch.tensor([xc, yt - 3.7, np.pi / 2.0, 0.0], dtype=dtype)
        layout_list.append(dataclasses.replace(base, obstacles=obs, xF=xF))
    return _grouped_batch(rng, layout_list, layout_verts, base, B,
                          n_layouts, pose_spread, psi_spread, dtype, device)


def randomized_parallel_parking_specs(B, n_layouts=8, seed=0, N=80, Ts=0.3,
                                      pose_spread=0.4, psi_spread=0.1,
                                      vary_topology=True,
                                      dtype=torch.float64, device="cuda"):
    """Parallel-parking batch with randomized start poses and obstacles.

    Per layout: slot half-length 3.85-4.4 m, slot centre +-0.6 m, curb
    top 2.3-2.7 m, block tops 4.8-5.2 m; with ``vary_topology`` the
    slot-entrance corners may be bevelled and a parked-car box may stand
    at the top of the street, padded to (4 obstacles, 5 faces).  The
    goal parks centred in the drawn slot 0.2 m off the drawn curb, and
    each layout's state box starts 0.1 m above its curb (``xy_lo`` =
    [-12, curb + 0.1]).  Same return value and start-pose rejection as
    :func:`randomized_reverse_parking_specs`.
    """
    if B % n_layouts:
        raise ValueError(f"B={B} must be a multiple of "
                         f"n_layouts={n_layouts}")
    rng = np.random.default_rng(seed)
    mo, mf = (4, 5) if vary_topology else (None, None)
    base = parallel_parking_spec(N=N, Ts=Ts, dtype=dtype, max_obs=mo,
                                 max_faces=mf, device="cpu")
    layout_list, layout_verts = [], []
    for _ in range(n_layouts):
        gh = rng.uniform(3.85, 4.4)       # slot half-length
        xs = rng.uniform(-0.6, 0.6)       # slot centre
        yc = rng.uniform(2.3, 2.7)        # curb top
        yb = rng.uniform(4.8, 5.2)        # block tops
        xl, xr = xs - gh, xs + gh         # slot edges
        if vary_topology and rng.random() < 0.5:
            bw, bh = rng.uniform(0.15, 0.4, size=2)
            left = [(-15.0, yb), (xl - bw, yb), (xl, yb - bh),
                    (xl, 0.0), (-15.0, 0.0)]
        else:
            left = [(-15.0, yb), (xl, yb), (xl, 0.0), (-15.0, 0.0)]
        if vary_topology and rng.random() < 0.5:
            bw, bh = rng.uniform(0.15, 0.4, size=2)
            right = [(xr, yb - bh), (xr + bw, yb), (15.0, yb),
                     (15.0, 0.0), (xr, 0.0)]
        else:
            right = [(xr, yb), (15.0, yb), (15.0, 0.0), (xr, 0.0)]
        vlist = [
            left, right,
            [(-15.0, yc), (15.0, yc), (15.0, 0.0), (-15.0, 0.0)],
        ]
        if vary_topology and rng.random() < 0.5:
            # A car parked on the opposite side, at the top of the street.
            x0b = rng.uniform(-2.0, 6.0)
            wb = rng.uniform(4.0, 7.0)
            y0b = rng.uniform(8.9, 9.3)
            vlist.append([(x0b, 10.0), (x0b + wb, 10.0),
                          (x0b + wb, y0b), (x0b, y0b)])
        layout_verts.append(vlist)
        obs = obstacles_from_vertices(vlist, max_obs=mo, max_faces=mf,
                                      dtype=dtype, device="cpu")
        # Centred in the slot (rear axle 1.35 m behind the car centre),
        # 0.2 m above the drawn curb; the state box tracks the curb.
        xF = torch.tensor([xs - 1.35, yc + 1.2, 0.0, 0.0], dtype=dtype)
        layout_list.append(dataclasses.replace(
            base, obstacles=obs, xF=xF,
            xy_lo=torch.tensor([-12.0, yc + 0.1], dtype=dtype)))
    return _grouped_batch(rng, layout_list, layout_verts, base, B,
                          n_layouts, pose_spread, psi_spread, dtype, device)
