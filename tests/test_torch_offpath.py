"""obca_torch's off-path helpers against obca_tpu's, at N=10.

The helpers no solve calls (geometry's ego polytope and ground-truth
distances, ``dynamics.dynamics_defects``, ``obca.dual_distance``,
``nlp.unpack_w`` / ``pack_w`` / ``objective_gradient`` /
``coupling_block`` / ``assemble_kkt``, ``nav.assemble_kkt``,
``blocktri.solve_refined`` / ``dense_from_blocks``, ``lattice.plan``
and ``ipm.default_init``) on the same inputs, made from a numpy seed,
in float64 on the CPU: every value within 1e-10 of JAX's; the lattice
path's integer parts exactly and its poses within 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import dynamics as tdyn
from obca_torch import geometry as tgeo
from obca_torch import nav as tnav
from obca_torch import nlp as tnlp
from obca_torch import obca as tobca
from obca_torch import spec as tspec
from obca_torch.convert import nav_spec_from_numpy, spec_from_numpy
from obca_torch.solver import blocktri as tbt
from obca_torch.solver import ipm as tipm
from obca_torch.warmstart import lattice as tlat
from obca_tpu import dynamics as jdyn
from obca_tpu import geometry as jgeo
from obca_tpu import nav as jnav
from obca_tpu import nlp as jnlp
from obca_tpu import obca as jobca
from obca_tpu.solver import blocktri as jbt
from obca_tpu.solver import ipm as jipm
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec
from obca_tpu.warmstart import lattice as jlat

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

ATOL = 1e-10
NAV_VERTS = [
    [(-4.0, 0.5), (-2.0, 0.5), (-2.0, 5.0), (-4.0, 5.0)],
    [(2.0, -5.0), (4.0, -5.0), (4.0, -0.5), (2.0, -0.5)],
]


def _to_numpy_tree(obj):
    """A JAX dataclass as a dict of numpy leaves (everything else as
    is)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_numpy_tree(v)
        elif isinstance(v, jax.Array):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _kkt_inputs(L, rng):
    Np1 = L.N + 1
    return dict(
        nu=rng.standard_normal((Np1, L.nc)),
        sigma_w=rng.uniform(0.0, 2.0, (Np1, L.nw)),
        sigma_c=-rng.uniform(1e-3, 1.0, (Np1, L.nc)),
        rhs_w=rng.standard_normal((Np1, L.nw)),
        rhs_c=rng.standard_normal((Np1, L.nc)),
    )


@pytest.fixture(scope="module")
def case():
    """(JAX spec at N=10 with dual_ref at the warm start, port spec [1],
    layout, perturbed warm start W0, seeded KKT inputs, rng)."""
    jspec = j_reverse_parking_spec(N=10, Ts=2.0)
    L = jnlp.layout_of(jspec)
    rng = np.random.default_rng(0)
    W0 = np.asarray(jax.jit(jnlp.default_init)(jspec))
    W0 = W0 + 0.05 * rng.standard_normal(W0.shape)
    jspec = dataclasses.replace(jspec, dual_ref=jnp.asarray(np.concatenate(
        [W0[:, L.sl_lam], W0[:, L.sl_mu]], axis=-1)))
    tsp = tspec.stack([spec_from_numpy(_to_numpy_tree(jspec), device="cpu")])
    return jspec, tsp, L, W0, _kkt_inputs(L, rng), rng


def _poses(rng, n):
    return np.column_stack([rng.uniform(-8, 8, n), rng.uniform(2, 9, n),
                            rng.uniform(-np.pi, np.pi, n),
                            rng.uniform(-1, 2, n)])


def test_geometry_ego_polytope_matches_jax(case):
    """ego_vertices, ego_hrep_world and sat_gap on random poses."""
    jspec, _, _, _, _, rng = case
    poses = _poses(rng, 12)
    g = np.asarray(jspec.ego_g)
    V_j = jax.vmap(lambda x: jgeo.ego_vertices(x, jspec.ego_g))(
        jnp.asarray(poses))
    V_t = tgeo.ego_vertices(_t(poses), _t(g))
    _close(V_t, V_j)
    Aw_j, bw_j = jax.vmap(lambda x: jgeo.ego_hrep_world(x, jspec.ego_g))(
        jnp.asarray(poses))
    Aw_t, bw_t = tgeo.ego_hrep_world(_t(poses), _t(g))
    _close(Aw_t, Aw_j)
    _close(bw_t, bw_j)
    # SAT gap of each ego box against each obstacle (axes as
    # ego_clearance_exact picks them: padded faces -> face 0).
    obs = jspec.obstacles
    A = np.asarray(obs.A)
    fm = np.asarray(obs.face_mask)
    verts = np.asarray(obs.vertices)
    axes_o = np.where(fm[..., None] > 0, A, A[:, :1])
    for m in range(A.shape[0]):
        want = jax.vmap(lambda P, PA: jgeo.sat_gap(
            P, PA, jnp.asarray(verts[m]), jnp.asarray(axes_o[m])))(
            V_j, Aw_j)
        got = tgeo.sat_gap(V_t, Aw_t, _t(verts[m]).expand(12, -1, -1),
                           _t(axes_o[m]).expand(12, -1, -1))
        _close(got, want)


def test_geometry_host_distances_match_jax(case):
    """point_polytope_distance and polytope_polytope_distance (numpy
    ground truth) on points and obstacle pairs of the scenario."""
    jspec, _, _, _, _, rng = case
    obs = jspec.obstacles
    A, b = np.asarray(obs.A), np.asarray(obs.b)
    fm = np.asarray(obs.face_mask)
    M = A.shape[0]
    for y in rng.uniform([-10, -2], [10, 12], (10, 2)):
        for m in range(M):
            assert tgeo.point_polytope_distance(y, A[m], b[m], fm[m]) == \
                pytest.approx(jgeo.point_polytope_distance(
                    y, A[m], b[m], fm[m]), abs=ATOL)
    for i in range(M):
        for j in range(M):
            assert tgeo.polytope_polytope_distance(
                A[i], b[i], A[j], b[j], fm[i], fm[j]) == pytest.approx(
                jgeo.polytope_polytope_distance(
                    A[i], b[i], A[j], b[j], fm[i], fm[j]), abs=ATOL)


def test_dynamics_defects_and_dual_distance_match_jax(case):
    jspec, _, L, W0, _, rng = case
    X = W0[:, L.sl_x] + 0.1 * rng.standard_normal((L.N + 1, 4))
    U = W0[:L.N, L.sl_u]
    d_j = jdyn.dynamics_defects(jnp.asarray(X), jnp.asarray(U), 1.1,
                                jspec.Ts, jspec.wheelbase)
    d_t = tdyn.dynamics_defects(_t(X)[None], _t(U)[None],
                                _t([1.1])[:, None], _t([float(jspec.Ts)])
                                [:, None], _t([float(jspec.wheelbase)])
                                [:, None])
    _close(d_t[0], d_j)
    obs = jspec.obstacles
    poses = _poses(rng, 6)
    lam = rng.uniform(0, 1, (6,) + obs.b.shape)
    mu = rng.uniform(0, 1, (6, obs.b.shape[0], 4))
    got = tobca.dual_distance(_t(poses), _t(lam), _t(mu), _t(obs.A),
                              _t(obs.b), _t(jspec.ego_g))
    for i in range(6):
        _close(got[i], jobca.dual_distance(
            jnp.asarray(poses[i]), jnp.asarray(lam[i]), jnp.asarray(mu[i]),
            obs.A, obs.b, jspec.ego_g))


def test_nlp_pack_unpack_and_objective_gradient_match_jax(case):
    jspec, tsp, L, W0, _, _ = case
    parts_j = jnlp.unpack_w(L, jnp.asarray(W0))
    parts_t = tnlp.unpack_w(L, _t(W0)[None])
    for got, want in zip(parts_t, parts_j):
        _close(got[0], want, atol=0.0)
    _close(tnlp.pack_w(L, *parts_t)[0], jnlp.pack_w(L, *parts_j), atol=0.0)
    _close(tnlp.pack_w(L, *parts_t), _t(W0)[None], atol=0.0)
    g_j = jax.jit(lambda W: jnlp.objective_gradient(L, W, jspec))(
        jnp.asarray(W0))
    _close(tnlp.objective_gradient(L, _t(W0)[None], tsp)[0], g_j)


@pytest.mark.parametrize("fix_time", [True, False])
def test_nlp_coupling_block_and_assemble_kkt_match_jax(case, fix_time):
    """The dense coupling E (both tau links) and the dense assembly:
    K and rhs as the structured one's, E as coupling_block."""
    jspec, tsp, L, W0, inp, _ = case
    if not fix_time:
        jspec = dataclasses.replace(jspec, fix_time=False)
        tsp = dataclasses.replace(tsp, fix_time=False)
        L = jnlp.layout_of(jspec)
    active_j, _ = jnlp.constraint_masks(L, jspec)
    active_t, _ = tnlp.constraint_masks(L, tsp)
    E_t = tnlp.coupling_block(L, tsp, active_t)
    _close(E_t[0], jnlp.coupling_block(L, jspec, active_j), atol=0.0)
    names = ("nu", "sigma_w", "sigma_c", "rhs_w", "rhs_c")
    K_j, E_j, rhs_j = jax.jit(
        lambda W, nu, sw, sc, rw, rc: jnlp.assemble_kkt(
            L, W, nu, sw, sc, rw, rc, jspec, active_j, jnp.asarray(1e-4)))(
        jnp.asarray(W0), *[jnp.asarray(inp[n]) for n in names])
    K_t, E_t, rhs_t = tnlp.assemble_kkt(
        L, _t(W0)[None], *[_t(inp[n])[None] for n in names], tsp, active_t,
        _t([1e-4]))
    for got, want in ((K_t, K_j), (E_t, E_j), (rhs_t, rhs_j)):
        _close(got[0], want)


def test_nav_assemble_kkt_matches_jax():
    jspec = jnav.nav_spec(N=10, vertex_lists=NAV_VERTS)
    L = jnav.layout_of(jspec)
    rng = np.random.default_rng(1)
    W0 = np.asarray(jax.jit(jnav.default_init)(jspec))
    W0 = W0 + 0.05 * rng.standard_normal(W0.shape)
    jspec = dataclasses.replace(jspec, dual_ref=jnp.asarray(W0[:, L.sl_lam]))
    tsp = tspec.stack([nav_spec_from_numpy(_to_numpy_tree(jspec),
                                           device="cpu")])
    inp = _kkt_inputs(L, rng)
    active_j, _ = jnav.constraint_masks(L, jspec)
    active_t, _ = tnav.constraint_masks(L, tsp)
    names = ("nu", "sigma_w", "sigma_c", "rhs_w", "rhs_c")
    K_j, E_j, rhs_j = jax.jit(
        lambda W, nu, sw, sc, rw, rc: jnav.assemble_kkt(
            L, W, nu, sw, sc, rw, rc, jspec, active_j, jnp.asarray(1e-4)))(
        jnp.asarray(W0), *[jnp.asarray(inp[n]) for n in names])
    K_t, E_t, rhs_t = tnav.assemble_kkt(
        L, _t(W0)[None], *[_t(inp[n])[None] for n in names], tsp, active_t,
        _t([1e-4]))
    for got, want in ((K_t, K_j), (E_t, E_j), (rhs_t, rhs_j)):
        _close(got[0], want)


def _qd_system(rng, S, nw, nc):
    nz = nw + nc
    M = rng.standard_normal((S, nw, nw))
    A = M @ np.swapaxes(M, -1, -2) / nw + np.eye(nw)
    Q = rng.standard_normal((S, nc, nc))
    D = -(Q @ np.swapaxes(Q, -1, -2) / nc + np.eye(nc))
    J = rng.standard_normal((S, nc, nw))
    K = np.concatenate([np.concatenate([A, np.swapaxes(J, -1, -2)], -1),
                        np.concatenate([J, D], -1)], -2)
    E = 0.3 * rng.standard_normal((S - 1, nz, nz))
    return K, E, rng.standard_normal((S, nz))


@pytest.mark.parametrize("factor_dtype", [np.float64, np.float32])
def test_blocktri_solve_refined_and_dense_match_jax(factor_dtype):
    """solve_refined with an f64 and an f32 factor (the mixed-precision
    use), and dense_from_blocks."""
    rng = np.random.default_rng(2)
    K, E, r = _qd_system(rng, 6, 4, 3)
    jfac = jbt.factor(jnp.asarray(K, factor_dtype),
                      jnp.asarray(E, factor_dtype), nw=4)
    x_j = jbt.solve_refined(jnp.asarray(K), jnp.asarray(E), jfac,
                            jnp.asarray(r), iters=2)
    fd = torch.float32 if factor_dtype == np.float32 else torch.float64
    tfac = tbt.factor(_t(K)[None].to(fd), _t(E)[None].to(fd), nw=4)
    x_t = tbt.solve_refined(_t(K)[None], _t(E)[None], tfac, _t(r)[None],
                            iters=2)
    _close(x_t[0], x_j)
    _close(tbt.dense_from_blocks(_t(K)[None], _t(E)[None])[0],
           jbt.dense_from_blocks(jnp.asarray(K), jnp.asarray(E)), atol=0.0)


def test_lattice_plan_and_default_init_match_jax(case):
    jspec, tsp, L, _, _, _ = case
    j_out = jlat.plan(jspec)
    base = spec_from_numpy(_to_numpy_tree(j_reverse_parking_spec(
        N=10, Ts=2.0)), device="cpu")
    t_out = tlat.plan(base)
    poses, dirs, seg_len, n_valid, reached = t_out
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(j_out[1]))
    assert int(n_valid) == int(j_out[3])
    assert bool(reached) == bool(j_out[4])
    _close(poses, j_out[0], atol=1e-9)
    _close(seg_len, j_out[2], atol=1e-9)
    W_j = jax.jit(lambda s: jipm.default_init(s))(jspec)
    _close(tipm.default_init(tsp)[0], W_j)
