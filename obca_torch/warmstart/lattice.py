"""Collision-aware coarse path search: SE(2) lattice value iteration.

Port of ``obca_tpu.warmstart.lattice``: value iteration on a dense
(x, y, heading) lattice with six arc motion primitives (forward/reverse
x left/straight/right), exact SAT occupancy, goal-escape staging seeds
combined by an integer scatter-min, greedy path extraction per lane,
and a connector + reversed-escape tail onto the exact goal.

The JAX package sweeps with static pad+slice shifts on the TPU (its
gather-free fast path).  The port sweeps with one precomputed gather
index per primitive (the JAX package's fallback form); because min is
exact, both give the identical value function.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from obca_torch import geometry
from obca_torch._util import linspace

N_TAIL = 16
_BIGKEY = 2 ** 30


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    nx: int = 128
    ny: int = 64
    nh: int = 36
    n_sweeps: int = 140
    max_steps: int = 110
    delta_frac: float = 0.95    # fraction of steering bound for arcs
    reverse_penalty: float = 1.3
    turn_penalty: float = 1.05
    clearance: float = 0.02     # occupancy margin beyond d_min
    # Static grid geometry: when set, the primitive cell offsets come
    # from :func:`motion_offsets_static` (float64 numpy), as in the JAX
    # package's static-shift path.
    grid_lo: tuple | None = None
    grid_hi: tuple | None = None
    max_kappa: float | None = None

    @staticmethod
    def for_spec(spec, **overrides) -> "LatticeConfig":
        """Static-geometry config for an (unbatched) spec."""
        cfg = LatticeConfig(**overrides)
        lo = spec.xy_lo.detach().cpu().double().numpy()
        hi = spec.xy_hi.detach().cpu().double().numpy()
        kap = float(np.tan(cfg.delta_frac * float(spec.u_hi[0]))
                    / float(spec.wheelbase))
        return dataclasses.replace(
            cfg, grid_lo=(float(lo[0]), float(lo[1])),
            grid_hi=(float(hi[0]), float(hi[1])), max_kappa=kap)


def default_config(spec) -> LatticeConfig:
    return LatticeConfig.for_spec(spec)


def _grid_params(xy_lo, xy_hi, cfg: LatticeConfig):
    res = (xy_hi - xy_lo) / torch.tensor([cfg.nx, cfg.ny], dtype=xy_lo.dtype,
                                         device=xy_lo.device)
    return xy_lo, xy_hi, res


def motion_table(spec, cfg: LatticeConfig):
    """Primitive table for an unbatched spec: (offs [nh, 6, 3] int,
    deltas [nh, 6, 3], cost [6], prim_dir [6], kappas [6], rho, ds)."""
    dt, dev = spec.x0.dtype, spec.x0.device
    _, _, res = _grid_params(spec.xy_lo, spec.xy_hi, cfg)
    dpsi_bin = 2.0 * np.pi / cfg.nh
    rho = spec.wheelbase / torch.tan(cfg.delta_frac * spec.u_hi[0])
    ds = rho * dpsi_bin
    hs = (torch.arange(cfg.nh, dtype=dt, device=dev) * dpsi_bin)[:, None]
    prim_dir = torch.tensor([1.0, 1.0, 1.0, -1.0, -1.0, -1.0], dtype=dt,
                            device=dev)
    prim_turn = torch.tensor([1.0, 0.0, -1.0, 1.0, 0.0, -1.0], dtype=dt,
                             device=dev)
    d = prim_dir * ds
    kappa = prim_turn / rho
    dpsi = d * kappa
    straight = prim_turn == 0.0
    ksafe = torch.where(straight, torch.ones_like(kappa), kappa)
    dx = torch.where(straight, d * torch.cos(hs),
                     (torch.sin(hs + dpsi) - torch.sin(hs)) / ksafe)
    dy = torch.where(straight, d * torch.sin(hs),
                     -(torch.cos(hs + dpsi) - torch.cos(hs)) / ksafe)
    deltas = torch.stack([dx, dy, dpsi.expand_as(dx)], dim=-1)
    dxy = torch.round(deltas[..., :2] / res).to(torch.int64)
    dh = torch.round(deltas[..., 2] / dpsi_bin).to(torch.int64)
    offs = torch.cat([dxy, dh[..., None]], dim=-1)
    one = torch.ones_like(prim_dir)
    cost = ds * torch.where(prim_dir < 0, cfg.reverse_penalty * one, one)
    cost = cost * torch.where(prim_turn != 0.0, cfg.turn_penalty * one, one)
    return offs, deltas, cost, prim_dir, prim_turn / rho, rho, ds


def motion_offsets_static(cfg: LatticeConfig) -> np.ndarray:
    """Numpy (float64) primitive cell offsets [nh, 6, 3] from the static
    grid geometry of ``cfg``."""
    lo = np.asarray(cfg.grid_lo, float)
    hi = np.asarray(cfg.grid_hi, float)
    res = (hi - lo) / np.asarray([cfg.nx, cfg.ny], float)
    dpsi_bin = 2.0 * np.pi / cfg.nh
    rho = 1.0 / cfg.max_kappa
    ds = rho * dpsi_bin
    hs = np.arange(cfg.nh) * dpsi_bin
    prim_dir = np.asarray([1.0, 1.0, 1.0, -1.0, -1.0, -1.0])
    prim_turn = np.asarray([1.0, 0.0, -1.0, 1.0, 0.0, -1.0])
    offs = np.zeros((cfg.nh, 6, 3), np.int64)
    for p in range(6):
        d = prim_dir[p] * ds
        kappa = prim_turn[p] / rho
        dpsi = d * kappa
        if prim_turn[p] == 0.0:
            dx = d * np.cos(hs)
            dy = d * np.sin(hs)
        else:
            dx = (np.sin(hs + dpsi) - np.sin(hs)) / kappa
            dy = -(np.cos(hs + dpsi) - np.cos(hs)) / kappa
        offs[:, p, 0] = np.round(dx / res[0])
        offs[:, p, 1] = np.round(dy / res[1])
        offs[:, p, 2] = np.round(dpsi / dpsi_bin)
    return offs


def occupancy(spec, cfg: LatticeConfig):
    """[nx, ny, nh] occupancy (1 = blocked) of an unbatched spec by the
    exact SAT clearance test."""
    dt, dev = spec.x0.dtype, spec.x0.device
    lo, _, res = _grid_params(spec.xy_lo, spec.xy_hi, cfg)
    xs = lo[0] + (torch.arange(cfg.nx, dtype=dt, device=dev) + 0.5) * res[0]
    ys = lo[1] + (torch.arange(cfg.ny, dtype=dt, device=dev) + 0.5) * res[1]
    hs = torch.arange(cfg.nh, dtype=dt, device=dev) * (2.0 * np.pi / cfg.nh)
    margin = spec.d_min + cfg.clearance
    PX, PY, PH = torch.meshgrid(xs, ys, hs, indexing="ij")
    gaps = geometry.ego_clearance_flat(PX.reshape(-1), PY.reshape(-1),
                                       PH.reshape(-1), spec.ego_g,
                                       spec.obstacles)
    return (gaps < margin).to(dt).reshape(cfg.nx, cfg.ny, cfg.nh)


def _drive(pose, d, kappa, u):
    """Pose after driving arclength u with direction d, curvature kappa
    (all broadcasting; pose [..., >=3])."""
    h0 = pose[..., 2]
    straight = torch.abs(kappa) < 1e-12
    ksafe = torch.where(straight, torch.ones_like(kappa), kappa)
    dpsi = d * u * kappa
    x = torch.where(straight, pose[..., 0] + d * u * torch.cos(h0),
                    pose[..., 0] + (torch.sin(h0 + dpsi) - torch.sin(h0))
                    / ksafe)
    y = torch.where(straight, pose[..., 1] + d * u * torch.sin(h0),
                    pose[..., 1] - (torch.cos(h0 + dpsi) - torch.cos(h0))
                    / ksafe)
    return torch.stack([x, y, h0 + dpsi], dim=-1)


def _escape_pose(xF, u, esc):
    """Pose at arclength u along the two-segment goal-escape maneuver
    esc = (d1, k1, l1, d2, k2, l2) driven out of the goal pose xF."""
    d1, k1, l1, d2, k2, l2 = esc
    u1 = torch.minimum(u, l1)
    u2 = torch.minimum(torch.clamp(u - l1, min=0.0), l2)
    p1 = _drive(xF[..., :3], d1, k1, u1)
    return _drive(p1, d2, k2, u2)


def _to_cell(pose, lo, res, cfg: LatticeConfig):
    """Cell indices of poses [..., >=3]: truncation toward zero, clip;
    heading bin by round-half-even and a divisor-signed modulo."""
    hsz = 2.0 * np.pi / cfg.nh
    cx = ((pose[..., 0] - lo[..., 0]) / res[..., 0]).to(torch.int64).clamp(
        0, cfg.nx - 1)
    cy = ((pose[..., 1] - lo[..., 1]) / res[..., 1]).to(torch.int64).clamp(
        0, cfg.ny - 1)
    ch = torch.remainder(torch.round(pose[..., 2] / hsz).to(torch.int64),
                         cfg.nh)
    return cx, cy, ch


def staging_goal(spec, cfg: LatticeConfig, occ, lo, res):
    """Goal-escape staging candidates of an unbatched spec: every
    two-segment escape (arc or straight, either direction) out of the
    goal, validated pose by pose with the exact SAT test.  Returns
    (flat esc params [6 x [C]], ok [C], scores [C], cx, cy, ch)."""
    dt, dev = spec.x0.dtype, spec.x0.device
    xF = spec.xF
    k_max = torch.tan(cfg.delta_frac * spec.u_hi[0]) / spec.wheelbase
    dirs_c = torch.tensor([1.0, -1.0], dtype=dt, device=dev)
    kappas_c = torch.stack([k_max, torch.zeros((), dtype=dt, device=dev),
                            -k_max])
    l1_c = linspace(0.0, 3.2, 5, dt, dev)
    l2_c = linspace(0.0, 5.0, 6, dt, dev)
    grids = torch.meshgrid(dirs_c, kappas_c, l1_c, dirs_c, kappas_c, l2_c,
                           indexing="ij")
    flat = [g.reshape(-1) for g in grids]
    d1, k1, l1, d2, k2, l2 = flat
    total = l1 + l2
    pose = _escape_pose(xF, total, flat)
    cx, cy, ch = _to_cell(pose, lo, res, cfg)
    free_c = occ[cx, cy, ch] < 0.5

    n_sub = 16
    frac = linspace(0.0, 1.0, n_sub, dt, dev)
    esc_sub = [f[:, None] for f in flat]
    p3 = _escape_pose(xF, frac * total[:, None], esc_sub)   # [C, n_sub, 3]
    gaps = geometry.ego_clearance_exact(p3, spec.ego_g, spec.obstacles)
    ramp = torch.clamp(frac * total[:, None] / 1.0, 0.0, 1.0)
    need = ramp * (spec.d_min + cfg.clearance)
    corridor_ok = (gaps.amin(-1) >= need).all(-1)
    score = total + 0.5 * (d1 != d2).to(dt)
    return flat, free_c & corridor_ok, score, cx, cy, ch


class PlanField(NamedTuple):
    """Start-independent planning artifacts of one scenario geometry
    (obstacles, goal, bounds): one field serves every start pose."""

    V: torch.Tensor          # [nx, ny, nh] value function
    occ: torch.Tensor        # [nx, ny, nh]
    seed_key: torch.Tensor   # [nx, ny, nh] int64 packed (score, index)
    seed_val: torch.Tensor   # [nx, ny, nh]
    esc_flat: tuple          # 6 x [C] escape parameters
    offs: torch.Tensor       # [nh, 6, 3] int64 primitive cell offsets
    cost: torch.Tensor       # [6]
    prim_dir: torch.Tensor   # [6]
    ds: torch.Tensor         # []
    succ: torch.Tensor       # [6, nx*ny*nh] successor flat index
    inb: torch.Tensor        # [6, nx*ny*nh] successor inside the grid


def _successors(offs, cfg: LatticeConfig):
    """Flat successor index and in-bounds mask per primitive."""
    dev = offs.device
    ix = torch.arange(cfg.nx, device=dev)[:, None, None]
    iy = torch.arange(cfg.ny, device=dev)[None, :, None]
    ih = torch.arange(cfg.nh, device=dev)[None, None, :]
    succ, inb = [], []
    for p in range(6):
        sx = ix + offs[:, p, 0]
        sy = iy + offs[:, p, 1]
        sh = torch.remainder(ih + offs[:, p, 2], cfg.nh)
        ok = (sx >= 0) & (sx < cfg.nx) & (sy >= 0) & (sy < cfg.ny)
        idx = ((sx.clamp(0, cfg.nx - 1) * cfg.ny + sy.clamp(0, cfg.ny - 1))
               * cfg.nh + sh)
        succ.append(idx.reshape(-1))
        inb.append(ok.reshape(-1))
    return torch.stack(succ), torch.stack(inb)


def plan_field(spec, cfg: LatticeConfig = LatticeConfig()) -> PlanField:
    """Compute the start-independent PlanField of an unbatched spec."""
    dt, dev = spec.x0.dtype, spec.x0.device
    lo, _, res = _grid_params(spec.xy_lo, spec.xy_hi, cfg)
    offs, _deltas, cost, prim_dir, _kappas, _rho, ds = motion_table(spec, cfg)
    if cfg.grid_lo is not None:
        offs = torch.as_tensor(motion_offsets_static(cfg), device=dev)
    occ = occupancy(spec, cfg)

    # Seed the value iteration with every qualifying goal-escape
    # endpoint, keyed round(score*256)*4096 + index so the scatter-min
    # keeps a tie-stable candidate.
    esc_flat, esc_ok, esc_scores, esc_cx, esc_cy, esc_ch = staging_goal(
        spec, cfg, occ, lo, res)
    big = torch.tensor(1e9, dtype=dt, device=dev)
    C = esc_ok.shape[0]
    iscore = torch.round(torch.where(
        esc_ok, esc_scores, torch.full_like(esc_scores, 1e5)) * 256.0).to(
            torch.int64)
    key = iscore * 4096 + torch.arange(C, device=dev)
    key = torch.where(esc_ok, key, torch.full_like(key, _BIGKEY))
    n_cell = cfg.nx * cfg.ny * cfg.nh
    flat_idx = (esc_cx * cfg.ny + esc_cy) * cfg.nh + esc_ch
    seed_key = torch.full((n_cell,), _BIGKEY, dtype=torch.int64, device=dev)
    seed_key = seed_key.scatter_reduce(0, flat_idx, key, "amin",
                                       include_self=True)
    seed_val = torch.where(seed_key < _BIGKEY,
                           (seed_key // 4096).to(dt) / 256.0, big)

    succ, inb = _successors(offs, cfg)
    free = (occ < 0.5).reshape(-1)
    V = seed_val
    for _ in range(cfg.n_sweeps):
        cand = torch.where(inb, V[succ] + cost[:, None], big)
        Vn = torch.minimum(V, cand.amin(0))
        Vn = torch.where(free, Vn, big)
        V = torch.minimum(Vn, seed_val)
    shape = (cfg.nx, cfg.ny, cfg.nh)
    return PlanField(V=V.reshape(shape), occ=occ,
                     seed_key=seed_key.reshape(shape),
                     seed_val=seed_val.reshape(shape),
                     esc_flat=tuple(esc_flat), offs=offs, cost=cost,
                     prim_dir=prim_dir, ds=ds, succ=succ, inb=inb)


def extract(spec, field: PlanField, cfg: LatticeConfig = LatticeConfig()):
    """Greedy descent of V from each lane's x0 (``spec`` batched [B]).

    Returns (poses [B, max_steps+1+N_TAIL, 3], dirs, seg_len, n_valid
    [B], reached [B]); dirs[i] / seg_len[i] describe the step into
    poses[i] (0 for i = 0 and padding).
    """
    dt, dev = spec.x0.dtype, spec.x0.device
    B = spec.x0.shape[0]
    lo, _, res = _grid_params(spec.xy_lo, spec.xy_hi, cfg)   # [B, 2]
    hsz = 2.0 * np.pi / cfg.nh
    V = field.V.reshape(-1)
    seed_val = field.seed_val.reshape(-1)
    seed_key = field.seed_key.reshape(-1)
    big = 1e9
    C = field.esc_flat[0].shape[0]
    offs = field.offs

    def cell_center(cx, cy, h_unw):
        px = lo[:, 0] + (cx.to(dt) + 0.5) * res[:, 0]
        py = lo[:, 1] + (cy.to(dt) + 0.5) * res[:, 1]
        return torch.stack([px, py, h_unw], dim=-1)

    cx, cy, ch = _to_cell(spec.x0, lo, res, cfg)
    h_unw = spec.x0[:, 2]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    poses, dirs = [], []
    for _ in range(cfg.max_steps):
        cell = (cx * cfg.ny + cy) * cfg.nh + ch
        sv = seed_val[cell]
        at_goal = (sv < 0.5 * big) & (sv <= V[cell] + 1e-9)
        done = done | at_goal
        vals = torch.where(field.inb[:, cell], V[field.succ[:, cell]]
                           + field.cost[:, None], big)         # [6, B]
        best_p = torch.argmin(vals, dim=0)
        dxyh = offs[ch, best_p]                                # [B, 3]
        cx = torch.where(done, cx, (cx + dxyh[:, 0]).clamp(0, cfg.nx - 1))
        cy = torch.where(done, cy, (cy + dxyh[:, 1]).clamp(0, cfg.ny - 1))
        ch = torch.where(done, ch, torch.remainder(ch + dxyh[:, 2], cfg.nh))
        h_unw = torch.where(done, h_unw, h_unw + dxyh[:, 2].to(dt) * hsz)
        poses.append(cell_center(cx, cy, h_unw))
        dirs.append(torch.where(done, torch.zeros_like(h_unw),
                                field.prim_dir[best_p]))
    reached = done
    final_pose = cell_center(cx, cy, h_unw)
    poses = torch.cat([spec.x0[:, None, :3], torch.stack(poses, 1)], dim=1)
    dirs = torch.cat([torch.zeros_like(dirs[0])[:, None],
                      torch.stack(dirs, 1)], dim=1)
    seg_len = torch.where(dirs != 0.0, field.ds, torch.zeros_like(dirs))

    # The escape candidate whose seed terminated the descent.
    idx = torch.remainder(seed_key[(cx * cfg.ny + cy) * cfg.nh + ch],
                          4096).clamp(0, C - 1)
    esc = [f[idx] for f in field.esc_flat]
    esc_d1, _, esc_l1, esc_d2, _, esc_l2 = esc
    esc_total = esc_l1 + esc_l2
    staging = _escape_pose(spec.xF, esc_total, esc)

    # Tail: connector (end pose -> staging) + reversed escape maneuver.
    n_conn = 4
    n_esc = N_TAIL - n_conn
    fracc = (torch.arange(n_conn, dtype=dt, device=dev) + 1.0) / n_conn
    dpsi_c = torch.atan2(torch.sin(staging[:, 2] - final_pose[:, 2]),
                         torch.cos(staging[:, 2] - final_pose[:, 2]))
    conn_poses = torch.stack([
        final_pose[:, None, 0] + fracc * (staging[:, None, 0]
                                          - final_pose[:, None, 0]),
        final_pose[:, None, 1] + fracc * (staging[:, None, 1]
                                          - final_pose[:, None, 1]),
        final_pose[:, None, 2] + fracc * dpsi_c[:, None],
    ], dim=-1)
    conn_step = torch.linalg.norm(staging[:, :2] - final_pose[:, :2],
                                  dim=-1) / n_conn
    frace = 1.0 - (torch.arange(n_esc, dtype=dt, device=dev) + 1.0) / n_esc
    esc_b = [e[:, None] for e in esc]
    esc_poses = _escape_pose(spec.xF[:, None], frace * esc_total[:, None],
                             esc_b)                           # [B, n_esc, 3]
    st2 = staging[:, None, 2]
    esc_poses = torch.cat([
        esc_poses[..., :2],
        (st2 + torch.atan2(torch.sin(esc_poses[..., 2] - st2),
                           torch.cos(esc_poses[..., 2] - st2)))[..., None],
    ], dim=-1)
    esc_step = esc_total / n_esc
    u_mid = esc_total[:, None] * (
        1.0 - (torch.arange(n_esc, dtype=dt, device=dev) + 0.5) / n_esc)
    seg2 = u_mid > esc_l1[:, None]
    esc_dirs = -torch.where(seg2, esc_d2[:, None], esc_d1[:, None])
    conn_dir = esc_dirs[:, :1]
    r = reached.to(dt)[:, None]
    tail_poses = torch.cat([conn_poses, esc_poses], dim=1)
    tail_dirs = torch.cat([conn_dir.expand(B, n_conn), esc_dirs], dim=1) * r
    tail_lens = torch.cat([conn_step[:, None].expand(B, n_conn),
                           esc_step[:, None].expand(B, n_esc)], dim=1) * r
    poses = torch.cat([poses, tail_poses], dim=1)
    dirs = torch.cat([dirs, tail_dirs], dim=1)
    seg_len = torch.cat([seg_len, tail_lens], dim=1)
    n_valid = (seg_len > 1e-9).sum(-1)
    return poses, dirs, seg_len, n_valid, reached
