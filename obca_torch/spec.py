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
