"""obca_torch's cyclic reduction against obca_tpu's, in float64 on the CPU.

The cases of ``tests/test_cyclic.py`` (S = 5, 16, 81 and the long
horizon S = 321), their systems from the same numpy draws: the port's
solution within 1e-8 of the JAX package's and of the port's sequential
``blocktri``; every level of the factor against JAX's; a B=4 batch
against JAX lane by lane; the stage padding; and the bench tool's CPU
run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obca_torch.solver import blocktri as tbt
from obca_torch.solver import cyclic as tcr
from obca_torch.tools import bench_cyclic
from obca_tpu.solver import cyclic as jcr

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

TOL = 1e-8


def _random_qd_system(rng, S, nw, nc, coupling=0.3):
    """tests/test_cyclic.py's generator."""
    nz = nw + nc
    Ks, Es = [], []
    for _ in range(S):
        R = rng.standard_normal((nw, nw))
        A = R @ R.T / nw + np.eye(nw)
        Q = rng.standard_normal((nc, nc))
        D = -(Q @ Q.T / nc + np.eye(nc))
        B = rng.standard_normal((nw, nc))
        Ks.append(np.block([[A, B], [B.T, D]]))
    for _ in range(S - 1):
        Es.append(coupling * rng.standard_normal((nz, nz)))
    return np.stack(Ks), np.reshape(Es, (S - 1, nz, nz))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("S,nw,nc,seed,coupling", [
    (5, 3, 2, 0, 0.3), (16, 4, 3, 0, 0.3), (81, 5, 4, 0, 0.3),
    (321, 6, 5, 1, 0.2)])
def test_cr_matches_jax_and_blocktri(S, nw, nc, seed, coupling):
    rng = np.random.default_rng(seed)
    K, E = _random_qd_system(rng, S, nw, nc, coupling)
    r = rng.standard_normal((S, nw + nc))
    jfac = jcr.factor(jnp.asarray(K), jnp.asarray(E), nw=nw)
    x_j = jcr.solve(jfac, jnp.asarray(r))
    Kt, Et, rt = (torch.tensor(a)[None] for a in (K, E, r))
    fac = tcr.factor(Kt, Et, nw=nw)
    x_t = tcr.solve(fac, rt)
    _close(x_t[0], x_j)
    assert len(fac.levels) == len(jfac.levels)
    for lev_t, lev_j in zip(fac.levels, jfac.levels):
        for a, b in zip(lev_t, lev_j):
            _close(a[0], b)
    _close(fac.root_inv[0], jfac.root_inv)
    _close(x_t, tbt.solve(tbt.factor(Kt, Et, nw=nw), rt))
    assert float((tbt.matvec(Kt, Et, x_t) - rt).abs().max()) < TOL


def test_cr_batch_matches_jax_per_lane():
    rng = np.random.default_rng(2)
    S, nw, nc, B = 9, 3, 2, 4
    systems = [_random_qd_system(rng, S, nw, nc) for _ in range(B)]
    K = np.stack([k for k, _ in systems])
    E = np.stack([e for _, e in systems])
    r = rng.standard_normal((B, S, nw + nc))
    x_t = tcr.solve(tcr.factor(torch.tensor(K), torch.tensor(E), nw=nw),
                    torch.tensor(r))
    for i in range(B):
        x_j = jcr.solve(jcr.factor(jnp.asarray(K[i]), jnp.asarray(E[i]),
                                   nw=nw), jnp.asarray(r[i]))
        _close(x_t[i], x_j)


@pytest.mark.parametrize("S", [1, 2, 5, 8])
def test_pad_to_pow2_matches_jax(S):
    rng = np.random.default_rng(3)
    nw, nc = 3, 2
    K, E = _random_qd_system(rng, S, nw, nc)
    Kj, Ej, Sj = jcr._pad_to_pow2(jnp.asarray(K), jnp.asarray(E), nw)
    Kt, Et, St = tcr._pad_to_pow2(torch.tensor(K)[None],
                                  torch.tensor(E)[None], nw)
    assert St == Sj == S
    _close(Kt[0], Kj, 0.0)
    _close(Et[0], Ej, 0.0)


def test_bench_cyclic_runs_on_cpu(capsys):
    rows, verdict = bench_cyclic.main(nw=4, nc=3, batch=2, sizes=(9, 17),
                                      device="cpu")
    assert [r["S"] for r in rows] == [9, 17]
    for r in rows:
        assert r["finite"]
        assert r["rel_diff_f64"] < TOL and r["residual_f64"] < TOL
        assert r["rel_diff_f32"] < 1e-4
        assert r["cyclic_f32_ms"] is None and r["speedup"] is None
        assert r["peak_mem_gb"] is None and r["device"] == "cpu"
    assert verdict.startswith("not measured")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3 and '"verdict"' in out[-1]
