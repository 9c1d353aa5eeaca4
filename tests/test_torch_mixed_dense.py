"""obca_torch's mixed-precision solve and dense-coupling solver against
obca_tpu on the same inputs.

* ``bwd_se_plain`` and ``solve_se_plain`` against the Pallas
  ``solve_batched_se`` in interpret mode;
* the dense-coupling plain versions (``factor_dense_plain``,
  ``solve_dense_plain``) against the Pallas ``factor_batched`` and
  ``solve_batched`` in interpret mode, on a dense coupling block;
* ``kkt.make_kkt_solver`` against the JAX Pallas route under ``vmap``;
* the mixed ``kkt.make_kkt_solver_se`` (f32 factor, f64 GCR) against the
  JAX Pallas route under ``vmap``;
* ``convert.config_from_numpy`` of the JAX mixed configuration.

The hand-written CUDA kernels are held against these plain versions in
``tests/test_torch_cuda.py``, which needs a card.  Inputs are made with
numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch import mixed_solver_config
from obca_torch.convert import config_from_numpy
from obca_torch.solver import kkt as tkkt
from obca_torch.solver.kernels import blocktri_dense as tbd
from obca_torch.solver.kernels import blocktri_se as tbk
from obca_tpu import spec as jspec
from obca_tpu.solver import kkt as jkkt
from obca_tpu.solver.pallas import blocktri_kernel as jbk

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

S, NW, NC, B = 7, 6, 5, 4
NZ = NW + NC
# The duplicate-free pattern of tests/test_torch_kernels.py: repeated
# rows and columns exercise the grouping by distinct column.
ROWS = np.array([6, 7, 8, 9, 4, 4, 5, 2, 0, 1, 3])
COLS = np.array([0, 1, 2, 3, 6, 7, 8, 2, 9, 10, 0])


def _qd_block(rng):
    """A well-conditioned symmetric quasidefinite stage block."""
    M = rng.standard_normal((NW, NW))
    A = M @ M.T / NW + 2.0 * np.eye(NW)
    Q = rng.standard_normal((NC, NC))
    D = -(Q @ Q.T / NC + np.eye(NC))
    J = rng.standard_normal((NC, NW))
    return np.block([[A, J.T], [J, D]])


@pytest.fixture(scope="module")
def system():
    """Batch-major numpy system: K [B, S, nz, nz], sparse coupling values
    ev [B, S-1, nnz], a dense coupling block E [B, S-1, nz, nz]
    (0.3 N(0, 1) / sqrt(nz)), reg [B, nz], r [B, S, nz]."""
    rng = np.random.default_rng(0)
    K = np.stack([np.stack([_qd_block(rng) for _ in range(S)])
                  for _ in range(B)])
    ev = 0.3 * rng.standard_normal((B, S - 1, len(ROWS)))
    E = 0.3 * rng.standard_normal((B, S - 1, NZ, NZ)) / np.sqrt(NZ)
    reg = np.tile(np.concatenate([np.full(NW, 1e-4), np.full(NC, -1e-4)]),
                  (B, 1))
    r = rng.standard_normal((B, S, NZ))
    return K, ev, E, reg, r


def _lanes_minor(a):
    """[B, ...] -> [..., B] (the Pallas kernels' batch-in-lanes layout)."""
    return jnp.asarray(np.moveaxis(a, 0, -1))


def _batch_major(a):
    return np.moveaxis(np.asarray(a), -1, 0)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_solve_se_plain_matches_pallas(system):
    """(a) rtol 1e-9, atol 1e-12 in float64: the JAX factor's outputs
    feed both sides."""
    K, ev, _, reg, r = system
    pat = tbk.CouplingPattern.of(ROWS, COLS)
    C = len(pat.ucols)
    Sinv_j, Wc_j, ucols = jbk.factor_batched_se(
        _lanes_minor(K), _lanes_minor(ev), _lanes_minor(reg), ROWS, COLS,
        NW, interpret=True)
    x_j = _batch_major(jbk.solve_batched_se(
        Sinv_j, Wc_j, _lanes_minor(ev), _lanes_minor(r), ROWS, COLS, ucols,
        interpret=True))
    y_j = _batch_major(jbk.fwd_se(Sinv_j, _lanes_minor(ev), _lanes_minor(r),
                                  ROWS, COLS, interpret=True))
    Sinv, Wc = _t(_batch_major(Sinv_j)), _t(_batch_major(Wc_j)[..., :C])

    x_t = tbk.solve_se(Sinv, Wc, _t(ev), _t(r), pat)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9, atol=1e-12)
    p_t = tbk.bwd_se(Wc, _t(y_j), pat)
    np.testing.assert_allclose(p_t.numpy(), x_j, rtol=1e-9, atol=1e-12)


def test_dense_plain_matches_pallas(system):
    """(b) rtol 1e-9, atol 1e-12 in float64, dense coupling block.  The
    Pallas factor inverts each stage pivot-free (primal block first), the
    plain version by LU with pivoting: on these well-conditioned blocks
    the two agree to rounding."""
    K, _, E, reg, r = system
    Kr = K + np.einsum("ij,bj->bij", np.eye(NZ), reg)[:, None]
    Sinv_j, W_j = jbk.factor_batched(_lanes_minor(Kr), _lanes_minor(E), NW,
                                     interpret=True)
    x_j = _batch_major(jbk.solve_batched(Sinv_j, W_j, _lanes_minor(E),
                                         _lanes_minor(r), interpret=True))
    Sinv_j, W_j = _batch_major(Sinv_j), _batch_major(W_j)

    Sinv_t, W_t = tbd.factor_dense(_t(Kr), _t(E))
    np.testing.assert_allclose(Sinv_t.numpy(), Sinv_j, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(W_t.numpy(), W_j, rtol=1e-9, atol=1e-12)
    x_t = tbd.solve_dense(_t(Sinv_j), _t(W_j), _t(E), _t(r))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9, atol=1e-12)
    y_t = tbd.fwd_dense(_t(Sinv_j), _t(E), _t(r))
    np.testing.assert_allclose(tbd.bwd_dense(_t(W_j), y_t).numpy(), x_j,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("stages", [1, 2])
def test_dense_plain_matches_pallas_short_chains(stages):
    """(b) on the shortest chains, rtol 1e-9, atol 1e-12 in float64: one
    stage (no coupling block, W empty) and two.  The card tests hold
    factor_dense and fwd_dense against these plain versions at S = 1."""
    rng = np.random.default_rng(3)
    K = np.stack([np.stack([_qd_block(rng) for _ in range(stages)])
                  for _ in range(2)])
    E = 0.3 * rng.standard_normal((2, stages - 1, NZ, NZ)) / np.sqrt(NZ)
    r = rng.standard_normal((2, stages, NZ))
    Sinv_j, W_j = jbk.factor_batched(_lanes_minor(K), _lanes_minor(E), NW,
                                     interpret=True)
    x_j = _batch_major(jbk.solve_batched(Sinv_j, W_j, _lanes_minor(E),
                                         _lanes_minor(r), interpret=True))

    Sinv_t, W_t = tbd.factor_dense(_t(K), _t(E))
    assert tuple(W_t.shape) == (2, stages - 1, NZ, NZ)
    np.testing.assert_allclose(Sinv_t.numpy(), _batch_major(Sinv_j),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(W_t.numpy(), _batch_major(W_j), rtol=1e-9,
                               atol=1e-12)
    x_t = tbd.solve_dense(Sinv_t, W_t, _t(E), _t(r))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9, atol=1e-12)


def test_kkt_solver_dense_matches_jax(system):
    """(c) the port's make_kkt_solver against the JAX Pallas route
    (interpret mode, under vmap): d to rtol 1e-8, the residual norms to
    1e-10 absolute (both reach rounding level)."""
    K, _, E, reg, r = system
    solve_t = tkkt.make_kkt_solver(NW, 4, torch.float64, torch.float64)
    solve_j = jkkt.make_kkt_solver(NW, 4, jnp.float64, jnp.float64,
                                   force_pallas=True, interpret=True)
    d_t, lin_t = solve_t(_t(K), _t(E), _t(reg), _t(r))
    d_j, lin_j = jax.vmap(solve_j)(jnp.asarray(K), jnp.asarray(E),
                                   jnp.asarray(reg), jnp.asarray(r))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-8,
                               atol=1e-10)
    assert float(lin_t.max()) <= 1e-10 and float(np.max(lin_j)) <= 1e-10


def test_mixed_kkt_solver_se_matches_jax(system):
    """(d) f32 factor, f64 GCR(4), against the JAX Pallas route
    (interpret mode, under vmap).  The two f32 factors round differently
    (pivoted LU against the pivot-free primal-first inverse), so p differs
    at f32 rounding; GCR in f64 takes both to the f64 solution.  Measured
    max |d_port - d_jax| 1.0e-15 (max |d| 1.14); tolerance rtol 1e-10,
    atol 1e-12, and both residual norms below 1e-10 (measured 9.2e-16
    and 2.1e-15)."""
    K, ev, _, reg, r = system
    solve_t = tkkt.make_kkt_solver_se(NW, 4, torch.float32, torch.float64,
                                      ROWS, COLS)
    solve_j = jkkt.make_kkt_solver_se(NW, 4, jnp.float32, jnp.float64,
                                      ROWS, COLS, force_pallas=True,
                                      interpret=True)
    d_t, lin_t = solve_t(_t(K), _t(ev), _t(reg), _t(r))
    d_j, lin_j = jax.vmap(solve_j)(jnp.asarray(K), jnp.asarray(ev),
                                   jnp.asarray(reg), jnp.asarray(r))
    assert d_t.dtype == torch.float64
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-10,
                               atol=1e-12)
    assert float(lin_t.max()) <= 1e-10 and float(np.max(lin_j)) <= 1e-10


def test_config_from_numpy_carries_mixed_dtypes():
    """(f) exact: the JAX mixed configuration's dtypes and knobs arrive
    as the port's own mixed configuration."""
    jcfg = jspec.mixed_solver_config(max_iter=200)
    tree = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        tree[f.name] = np.asarray(v) if isinstance(v, jax.Array) else v
    cfg = config_from_numpy(tree)
    ref = mixed_solver_config(max_iter=200)
    assert (cfg.dtype, cfg.factor_dtype, cfg.residual_dtype) == (
        torch.float64, torch.float32, torch.float64)
    for f in dataclasses.fields(ref):
        a, b = getattr(cfg, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            assert float(a) == float(b), f.name
        else:
            assert a == b, f.name
