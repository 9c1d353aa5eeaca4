"""obca_torch linear-algebra layer against obca_tpu on the same inputs.

* the plain versions of the three structured-coupling kernels against
  the Pallas kernels run in interpret mode;
* the batched ``blocktri`` twin against ``obca_tpu.solver.blocktri``;
* ``kkt.make_kkt_solver_se`` (batched) against the JAX per-scenario
  route under ``jax.vmap``;
* the port's isolation from JAX.

The hand-written CUDA kernels themselves are held against their plain
versions in ``tests/test_torch_cuda.py``, which needs a card.

Inputs are made with numpy from a seed and handed to both packages.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch.solver import blocktri as tbt
from obca_torch.solver import kkt as tkkt
from obca_torch.solver.kernels import blocktri_se as tbk
from obca_tpu.solver import blocktri as jbt
from obca_tpu.solver import kkt as jkkt
from obca_tpu.solver.pallas import blocktri_kernel as jbk

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

S, NW, NC, B = 7, 6, 5, 4
NZ = NW + NC
# A made-up duplicate-free coupling pattern with repeated rows and
# columns, so the kernels' grouping by distinct column is exercised.
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
    """Batch-major numpy system: K [B, S, nz, nz], ev [B, S-1, nnz],
    reg [B, nz], r [B, S, nz]."""
    rng = np.random.default_rng(0)
    K = np.stack([np.stack([_qd_block(rng) for _ in range(S)])
                  for _ in range(B)])
    ev = 0.3 * rng.standard_normal((B, S - 1, len(ROWS)))
    reg = np.tile(np.concatenate([np.full(NW, 1e-4), np.full(NC, -1e-4)]),
                  (B, 1))
    r = rng.standard_normal((B, S, NZ))
    return K, ev, reg, r


def _lanes_minor(a):
    """[B, ...] -> [..., B] (the Pallas kernels' batch-in-lanes layout)."""
    return jnp.asarray(np.moveaxis(a, 0, -1))


def _batch_major(a):
    return np.moveaxis(np.asarray(a), -1, 0)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_factor_fwd_bwd_plain_match_pallas(system):
    K, ev, reg, r = system
    pat = tbk.CouplingPattern.of(ROWS, COLS)
    C = len(pat.ucols)

    Sinv_j, Wc_j, ucols = jbk.factor_batched_se(
        _lanes_minor(K), _lanes_minor(ev), _lanes_minor(reg), ROWS, COLS,
        NW, interpret=True)
    assert list(ucols) == list(pat.ucols)
    Sinv_j, Wc_j = _batch_major(Sinv_j), _batch_major(Wc_j)[..., :C]
    Sinv_t, Wc_t = tbk.factor_se(_t(K), _t(ev), _t(reg), pat)
    np.testing.assert_allclose(Sinv_t.numpy(), Sinv_j, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(Wc_t.numpy(), Wc_j, rtol=1e-9, atol=1e-12)

    # Same inputs on both sides: the JAX factor's outputs feed both
    # substitutions.
    y_j = _batch_major(jbk.fwd_se(_lanes_minor(Sinv_j), _lanes_minor(ev),
                                  _lanes_minor(r), ROWS, COLS,
                                  interpret=True))
    y_t = tbk.fwd_se(_t(Sinv_j), _t(ev), _t(r), pat)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-9, atol=1e-12)

    Wc_pad = np.zeros(Wc_j.shape[:-1] + (8 * -(-C // 8),))
    Wc_pad[..., :C] = Wc_j
    p_j, Ap_j = jbk.bwd_matvec_se(
        _lanes_minor(Wc_pad), _lanes_minor(y_j), _lanes_minor(K),
        _lanes_minor(ev), ROWS, COLS, list(pat.ucols), interpret=True)
    p_t, Ap_t = tbk.bwd_matvec_se(_t(Wc_j), _t(y_j), _t(K), _t(ev), pat)
    np.testing.assert_allclose(p_t.numpy(), _batch_major(p_j), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(Ap_t.numpy(), _batch_major(Ap_j), rtol=1e-9,
                               atol=1e-12)


def test_plain_match_pallas_at_nz72():
    """At nz = 72, the stage size of the topology-varied randomized
    families (nw = 43, nc = 29: 4 obstacles of 5 faces), with their
    OBCA coupling pattern: the plain versions of every solver kernel
    (factor_se, fwd_se, bwd_matvec_se, bwd_se, and the dense factor and
    solve) against the Pallas kernels in interpret mode, B = 2, S = 3,
    rtol 1e-9, atol 1e-12 in float64; each substitution fed the JAX
    factor's outputs."""
    from obca_torch import nlp as tnlp
    from obca_torch import reverse_parking_spec
    from obca_torch.solver.kernels import blocktri_dense as tbd

    L = tnlp.layout_of(reverse_parking_spec(N=2, max_obs=4, max_faces=5,
                                            device="cpu"))
    nw, nz, s, b = L.nw, L.nz, 3, 2
    assert (nw, nz) == (43, 72)
    rows, cols = tnlp.coupling_structure(L)
    pat = tbk.CouplingPattern.of(rows, cols)
    C = len(pat.ucols)
    rng = np.random.default_rng(5)
    M = rng.standard_normal((b, s, nw, nw))
    A = M @ np.swapaxes(M, -1, -2) / nw + 2.0 * np.eye(nw)
    Q = rng.standard_normal((b, s, nz - nw, nz - nw))
    D = -(Q @ np.swapaxes(Q, -1, -2) / (nz - nw) + np.eye(nz - nw))
    J = rng.standard_normal((b, s, nz - nw, nw))
    K = np.concatenate([np.concatenate([A, np.swapaxes(J, -1, -2)], -1),
                        np.concatenate([J, D], -1)], -2)
    ev = 0.3 * rng.standard_normal((b, s - 1, len(rows)))
    reg = np.tile(np.concatenate([np.full(nw, 1e-4),
                                  np.full(nz - nw, -1e-4)]), (b, 1))
    r = rng.standard_normal((b, s, nz))
    tol = dict(rtol=1e-9, atol=1e-12)

    Sinv_j, Wc_j, ucols = jbk.factor_batched_se(
        _lanes_minor(K), _lanes_minor(ev), _lanes_minor(reg), rows, cols,
        nw, interpret=True)
    assert list(ucols) == list(pat.ucols)
    y_j = _batch_major(jbk.fwd_se(Sinv_j, _lanes_minor(ev),
                                  _lanes_minor(r), rows, cols,
                                  interpret=True))
    x_j = _batch_major(jbk.solve_batched_se(
        Sinv_j, Wc_j, _lanes_minor(ev), _lanes_minor(r), rows, cols, ucols,
        interpret=True))
    p_j, Ap_j = jbk.bwd_matvec_se(
        Wc_j, _lanes_minor(y_j), _lanes_minor(K), _lanes_minor(ev), rows,
        cols, list(pat.ucols), interpret=True)
    Sinv_j, Wc_j = _batch_major(Sinv_j), _batch_major(Wc_j)[..., :C]

    Sinv_t, Wc_t = tbk.factor_se(_t(K), _t(ev), _t(reg), pat)
    np.testing.assert_allclose(Sinv_t.numpy(), Sinv_j, **tol)
    np.testing.assert_allclose(Wc_t.numpy(), Wc_j, **tol)
    y_t = tbk.fwd_se(_t(Sinv_j), _t(ev), _t(r), pat)
    np.testing.assert_allclose(y_t.numpy(), y_j, **tol)
    p_t, Ap_t = tbk.bwd_matvec_se(_t(Wc_j), _t(y_j), _t(K), _t(ev), pat)
    np.testing.assert_allclose(p_t.numpy(), _batch_major(p_j), **tol)
    np.testing.assert_allclose(Ap_t.numpy(), _batch_major(Ap_j), **tol)
    np.testing.assert_allclose(tbk.bwd_se(_t(Wc_j), _t(y_j), pat).numpy(),
                               x_j, **tol)

    E = 0.3 * rng.standard_normal((b, s - 1, nz, nz)) / np.sqrt(nz)
    Kr = K + np.einsum("ij,bj->bij", np.eye(nz), reg)[:, None]
    Sd_j, W_j = jbk.factor_batched(_lanes_minor(Kr), _lanes_minor(E), nw,
                                   interpret=True)
    xd_j = _batch_major(jbk.solve_batched(Sd_j, W_j, _lanes_minor(E),
                                          _lanes_minor(r), interpret=True))
    Sd_j, W_j = _batch_major(Sd_j), _batch_major(W_j)
    Sd_t, W_t = tbd.factor_dense(_t(Kr), _t(E))
    np.testing.assert_allclose(Sd_t.numpy(), Sd_j, **tol)
    np.testing.assert_allclose(W_t.numpy(), W_j, **tol)
    yd_t = tbd.fwd_dense(_t(Sd_j), _t(E), _t(r))
    np.testing.assert_allclose(tbd.bwd_dense(_t(W_j), yd_t).numpy(), xd_j,
                               **tol)


def _list_pattern(kind):
    """(rows, cols, nz): the OBCA coupling pattern of the reverse-parking
    layout (rows with several entries and rows with none), or a random
    one with repeated (row, col) pairs whose rows 5..10 are empty."""
    if kind == "obca":
        from obca_torch import nlp, reverse_parking_spec

        L = nlp.layout_of(reverse_parking_spec(N=10, device="cpu"))
        rows, cols = nlp.coupling_structure(L)
        return rows, cols, L.nz
    rng = np.random.default_rng(3)
    return rng.integers(0, 5, size=20), rng.integers(0, NZ, size=20), NZ


@pytest.mark.parametrize("kind", ["obca", "random"])
def test_coupling_lists_match_brute_force(kind):
    """CouplingPattern's per-row coupling lists (start offsets and entry
    indices, by row and by column) against a plain scan of the pattern,
    and their int32 tensors."""
    rows, cols, nz = _list_pattern(kind)
    pat = tbk.CouplingPattern.of(rows, cols)
    lists = pat.lists(nz)
    tens = pat.lists_index(nz, "cpu")
    nnz = len(rows)
    for key, idx in (("r", rows), ("c", cols)):
        start, ent = lists[f"{key}start"], lists[f"{key}ent"]
        assert len(start) == nz + 1 and start[0] == 0 and start[-1] == nnz
        for i in range(nz):
            want = [j for j in range(nnz) if idx[j] == i]
            assert list(ent[start[i]:start[i + 1]]) == want
        for name, arr in ((f"{key}start", start), (f"{key}ent", ent)):
            assert tens[name].dtype == torch.int32
            assert tens[name].tolist() == list(arr)
    assert pat.lists_index(nz, "cpu") is tens   # cached
    if kind == "obca":
        counts = np.bincount(rows, minlength=nz)
        assert counts.max() > 1 and (counts == 0).any()


def test_blocktri_twin_matches_jax(system):
    K, ev, reg, r = system
    E = np.zeros((B, S - 1, NZ, NZ))
    E[:, :, ROWS, COLS] = ev
    fac = tbt.factor(_t(K), _t(E), nw=NW)
    x = tbt.solve(fac, _t(r))
    xg, lin = tbt.solve_gcr(_t(K), _t(E), fac, _t(r), m=4)
    for b in range(B):
        jfac = jbt.factor(jnp.asarray(K[b]), jnp.asarray(E[b]), nw=NW)
        np.testing.assert_allclose(fac.Sinv[b].numpy(), np.asarray(jfac.Sinv),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(fac.W[b].numpy(), np.asarray(jfac.W),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(
            x[b].numpy(), np.asarray(jbt.solve(jfac, jnp.asarray(r[b]))),
            rtol=1e-10, atol=1e-13)
        jx, jlin = jbt.solve_gcr(jnp.asarray(K[b]), jnp.asarray(E[b]), jfac,
                                 jnp.asarray(r[b]), m=4)
        np.testing.assert_allclose(xg[b].numpy(), np.asarray(jx),
                                   rtol=1e-10, atol=1e-13)
        assert float(lin[b]) <= 1e-10 and float(jlin) <= 1e-10
        np.testing.assert_allclose(
            tbt.matvec(_t(K), _t(E), x)[b].numpy(),
            np.asarray(jbt.matvec(jnp.asarray(K[b]), jnp.asarray(E[b]),
                                  jnp.asarray(x[b].numpy()))),
            rtol=1e-10, atol=1e-12)


def test_kkt_solver_se_batched_matches_jax(system):
    K, ev, reg, r = system
    solve_t = tkkt.make_kkt_solver_se(NW, 4, torch.float64, torch.float64,
                                      ROWS, COLS)
    solve_j = jkkt.make_kkt_solver_se(NW, 4, jnp.float64, jnp.float64,
                                      ROWS, COLS, force_pallas=False)
    d_t, lin_t = solve_t(_t(K), _t(ev), _t(reg), _t(r))
    d_j, lin_j = jax.vmap(solve_j)(jnp.asarray(K), jnp.asarray(ev),
                                   jnp.asarray(reg), jnp.asarray(r))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(lin_t.numpy(), np.asarray(lin_j), rtol=1e-4,
                               atol=1e-12)


def test_kkt_solver_se_rejects_duplicate_pattern():
    rows = np.array([0, 1, 2, 0])
    cols = np.array([3, 4, 5, 3])   # (0, 3) twice
    with pytest.raises(ValueError, match="duplicate"):
        tkkt.make_kkt_solver_se(NW, 4, torch.float64, torch.float64, rows,
                                cols)


def test_entry_points_default_to_the_card():
    """Without device=, an entry point builds on the card; without a
    card it raises instead of falling back to the CPU."""
    from obca_torch import reverse_parking_spec

    if torch.cuda.is_available():
        assert reverse_parking_spec(N=10).x0.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            reverse_parking_spec(N=10)
    assert reverse_parking_spec(N=10, device="cpu").x0.device.type == "cpu"


def test_port_imports_no_jax():
    """The port imports neither JAX nor obca_tpu, even while it solves."""
    code = textwrap.dedent("""
        import sys
        import torch
        import obca_torch
        from obca_torch import SolverConfig, reverse_parking_spec
        from obca_torch.solver import ipm
        from obca_torch.warmstart import geometric
        spec = reverse_parking_spec(N=12, Ts=2.0, device="cpu")
        W0 = geometric.lattice_warm_start(spec)
        res = ipm.solve_single(spec, SolverConfig(max_iter=2), W0)
        assert torch.isfinite(res.W).all()
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "obca_tpu")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1],
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
