"""obca_torch's NLP layer and lattice warm start against obca_tpu.

The NLP functions are compared at the golden warm start W0 of
``oracle/goldens/reverse_parking_N40.npz`` on the same spec instance
(the JAX spec is flattened to numpy and rebuilt with
``obca_torch.convert.spec_from_numpy``), with multipliers and barrier
terms drawn from a numpy seed.  The lattice warm start is held against
the golden W0 itself, which is the JAX package's own output
(``oracle/gen_goldens.py``).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import dynamics as tdyn
from obca_torch import geometry as tgeo
from obca_torch import nlp as tnlp
from obca_torch import obca as tobca
from obca_torch import reverse_parking_spec
from obca_torch import spec as tspec
from obca_torch.convert import spec_from_numpy
from obca_torch.warmstart import geometric, lattice, velosmooth
from obca_tpu import dynamics as jdyn
from obca_tpu import geometry as jgeo
from obca_tpu import nlp as jnlp
from obca_tpu import obca as jobca
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "oracle" / "goldens"
          / "reverse_parking_N40.npz")


def _to_numpy_tree(obj):
    """A JAX spec dataclass as a dict of numpy leaves (static fields as
    Python values)."""
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


@pytest.fixture(scope="module")
def case():
    gold = np.load(GOLDEN)
    W0 = gold["W0"]
    jspec = j_reverse_parking_spec(N=40, Ts=0.6)
    L = jnlp.layout_of(jspec)
    # The IPM anchors the proximal dual term at the warm-start duals.
    jspec = dataclasses.replace(jspec, dual_ref=jnp.asarray(np.concatenate(
        [W0[:, L.sl_lam], W0[:, L.sl_mu]], axis=-1)))
    tspec1 = spec_from_numpy(_to_numpy_tree(jspec), device="cpu")
    rng = np.random.default_rng(0)
    Np1 = L.N + 1
    inputs = dict(
        nu=rng.standard_normal((Np1, L.nc)),
        sigma_w=rng.uniform(0.0, 2.0, (Np1, L.nw)),
        sigma_c=-rng.uniform(1e-3, 1.0, (Np1, L.nc)),
        rhs_w=rng.standard_normal((Np1, L.nw)),
        rhs_c=rng.standard_normal((Np1, L.nc)),
        delta_w=np.asarray(1e-4),
    )
    return W0, jspec, tspec.stack([tspec1]), L, inputs


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)[None]


def test_constraints_and_lagrangian_gradient_match_jax(case):
    W0, jspec, tsp, L, inp = case
    active_j, _ = jnlp.constraint_masks(L, jspec)
    active_t, _ = tnlp.constraint_masks(tnlp.layout_of(tsp), tsp)
    np.testing.assert_array_equal(active_t[0].numpy(), np.asarray(active_j))

    c_j = jax.jit(lambda W: jnlp.all_constraints(L, W, jspec))(
        jnp.asarray(W0))
    c_t = tnlp.all_constraints(L, _t(W0), tsp)
    np.testing.assert_allclose(c_t[0].numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-10)

    g_j = jax.jit(jax.grad(lambda W, nu: jnlp.total_lagrangian(
        L, W, nu, jspec, active_j)))(jnp.asarray(W0), jnp.asarray(inp["nu"]))
    g_t = tnlp.lagrangian_gradient(L, _t(W0), _t(inp["nu"]), tsp, active_t)
    np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-10)
    f_j = jnlp.objective(L, jnp.asarray(W0), jspec)
    f_t = tnlp.objective(L, _t(W0), tsp)
    np.testing.assert_allclose(f_t.numpy(), [float(f_j)], rtol=1e-12)


def test_assemble_kkt_structured_matches_jax(case):
    W0, jspec, tsp, L, inp = case
    active_j, _ = jnlp.constraint_masks(L, jspec)
    active_t, _ = tnlp.constraint_masks(L, tsp)
    names = ("nu", "sigma_w", "sigma_c", "rhs_w", "rhs_c")
    K_j, ev_j, rhs_j = jax.jit(
        lambda W, nu, sw, sc, rw, rc, dw: jnlp.assemble_kkt_structured(
            L, W, nu, sw, sc, rw, rc, jspec, active_j, dw))(
        jnp.asarray(W0), *[jnp.asarray(inp[n]) for n in names],
        jnp.asarray(inp["delta_w"]))
    K_t, ev_t, rhs_t = tnlp.assemble_kkt_structured(
        L, _t(W0), *[_t(inp[n]) for n in names], tsp, active_t,
        torch.tensor([float(inp["delta_w"])], dtype=torch.float64))
    np.testing.assert_allclose(K_t[0].numpy(), np.asarray(K_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(ev_t[0].numpy(), np.asarray(ev_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(rhs_t[0].numpy(), np.asarray(rhs_j), rtol=0,
                               atol=1e-10)
    rows_j, cols_j = jnlp.coupling_structure(L)
    rows_t, cols_t = tnlp.coupling_structure(L)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(cols_t, cols_j)


def test_leaf_modules_match_jax():
    """geometry, dynamics and obca on random poses, inputs and duals."""
    rng = np.random.default_rng(1)
    jspec = j_reverse_parking_spec(N=40, Ts=0.6)
    obs = jspec.obstacles
    A, b = np.asarray(obs.A), np.asarray(obs.b)
    fm, g = np.asarray(obs.face_mask), np.asarray(jspec.ego_g)
    poses = np.column_stack([rng.uniform(-8, 8, 16), rng.uniform(2, 9, 16),
                             rng.uniform(-np.pi, np.pi, 16),
                             rng.uniform(-1, 2, 16)])
    for x in poses:
        for m in range(A.shape[0]):
            assert tgeo.ego_obstacle_distance(x, g, A[m], b[m], fm[m]) == \
                pytest.approx(jgeo.ego_obstacle_distance(x, g, A[m], b[m],
                                                         fm[m]), abs=1e-12)
    X = torch.tensor(poses)
    np.testing.assert_allclose(
        tgeo.rotation(X[:, 2]).numpy(),
        np.asarray(jgeo.rotation(jnp.asarray(poses[:, 2]))), atol=1e-15)

    U = rng.uniform(-0.5, 0.5, (12, 2))

    def ts(a):
        return torch.tensor(a, dtype=torch.float64)

    Xr = tdyn.rollout(ts(poses[0]), ts(U), ts(1.1), ts(0.6), ts(2.7))
    Xj = jdyn.rollout(jnp.asarray(poses[0]), jnp.asarray(U), 1.1, 0.6, 2.7)
    np.testing.assert_allclose(Xr.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-12)

    lam = rng.uniform(0, 1, (16,) + b.shape)
    mu = rng.uniform(0, 1, (16, b.shape[0], 4))
    got = tobca.obca_terms(X, ts(lam), ts(mu), ts(A), ts(b), ts(g))
    for i in range(16):
        want = jobca.obca_terms(jnp.asarray(poses[i]), jnp.asarray(lam[i]),
                                jnp.asarray(mu[i]), obs.A, obs.b,
                                jspec.ego_g)
        for t_, j_ in zip(got, want):
            np.testing.assert_allclose(t_[i].numpy(), np.asarray(j_),
                                       rtol=0, atol=1e-12)


def test_lattice_warm_start_matches_golden():
    """The whole warm-start chain — lattice (integer tie-break), the
    Reeds-Shepp fallback, the velocity profile and the geometric duals —
    reproduces the JAX package's golden W0."""
    gold = np.load(GOLDEN)
    spec = reverse_parking_spec(N=40, Ts=0.6, device="cpu")
    lcfg = lattice.LatticeConfig.for_spec(spec)
    field = lattice.plan_field(spec, lcfg)
    W0 = geometric.lattice_warm_start(spec, cfg=lcfg, field=field)
    np.testing.assert_allclose(W0.numpy(), gold["W0"], rtol=0, atol=1e-8)
    # The golden came from the lattice branch: the lattice reaches the
    # goal here, and the Reeds-Shepp fallback would give another W0.
    batch = tspec.stack([spec])
    *_, reached = lattice.extract(batch, field, lcfg)
    assert bool(reached[0])
    X_rs, U_rs = velosmooth.rs_time_sampled(batch)
    W_rs = geometric.warm_start(batch, X=X_rs, U=U_rs)
    assert np.abs(W_rs[0].numpy() - gold["W0"]).max() > 1e-2
