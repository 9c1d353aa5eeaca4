"""The IPM's Ruiz equilibration, ``blocktri_se.ruiz_se``, on the CPU
(its plain version; the kernel runs only on the card, where
``tests/test_torch_cuda.py`` holds it to the plain version bit for bit).

* The math: the structured sweeps against an independent dense
  formulation (the whole KKT matrix with its coupling blocks, scaled by
  the row maxima of |D A D|), on the coupling patterns of the
  benchmark's configurations (parking nz = 56, the cluttered lot nz =
  72, nav nz = 44), 3 and 4 sweeps, and a lane holding a NaN.
* The move: ``ipm``'s ``_ruiz`` calls the wrapper, once a turn, and
  returns what its former PyTorch expression returned, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import full_size_batches as fsb
from obca_torch import (f32_solver_config, mixed_solver_config, nav, nlp,
                        reverse_parking_spec)
from obca_torch import spec as tspec
from obca_torch.solver import ipm
from obca_torch.solver.kernels import blocktri_se as bk

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

# Relative gap of the two formulations: each multiplies in another order,
# which rounds differently by about an ulp an operation.
DENSE_RTOL = 1e-6


def _pattern(width):
    """(coupling pattern, nz) of a benchmark configuration's layout."""
    if width == "nav44":
        L = nav.layout_of(nav.nav_spec(N=4, vertex_lists=fsb.NAV_VERTS,
                                       device="cpu"))
        rows, cols = nav.coupling_structure(L)
    else:
        kw = dict(max_obs=4, max_faces=5) if width == "nz72" else {}
        L = nlp.layout_of(reverse_parking_spec(N=4, Ts=0.3, device="cpu",
                                               **kw))
        rows, cols = nlp.coupling_structure(L)
    return bk.CouplingPattern.of(rows, cols), L.nz


def _system(B, S, nz, nnz, dtype, seed=0):
    """A symmetric K [B, S, nz, nz] whose rows and columns span ten
    decades (as an IPM's do near its end), with exact zeros and one
    all-zero row and column (the clamp's case); ev [B, S-1, nnz] and rhs
    [B, S, nz]."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-5, 5, (B, S, nz))
    A = rng.standard_normal((B, S, nz, nz))
    A = A * (rng.random((B, S, nz, nz)) < 0.6)
    K = (A + np.swapaxes(A, -1, -2)) * scale[..., None] * scale[..., None, :]
    K[:, :, 3, :] = K[:, :, :, 3] = 0.0
    ev = rng.standard_normal((B, S - 1, nnz)) * 10.0 ** rng.uniform(
        -3, 3, (B, S - 1, nnz))
    rhs = rng.standard_normal((B, S, nz))
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (K, ev, rhs))


def _dense_ruiz(K, ev, rhs, pat, iters):
    """The same equilibration on the dense matrix A [B, S nz, S nz]:
    D <- D / sqrt(max(rowmax |D A D|, 1e-10)) from D = 1, then D A D."""
    B, S, nz, _ = K.shape
    n = S * nz
    A = torch.zeros((B, n, n), dtype=K.dtype)
    for s in range(S):
        A[:, s * nz:(s + 1) * nz, s * nz:(s + 1) * nz] = K[:, s]
    r = torch.as_tensor(pat.rows)
    c = torch.as_tensor(pat.cols)
    for s in range(S - 1):
        A[:, s * nz + r, (s + 1) * nz + c] = ev[:, s]
        A[:, (s + 1) * nz + c, s * nz + r] = ev[:, s]
    D = torch.ones((B, n), dtype=K.dtype)
    for _ in range(iters):
        rn = (D[:, :, None] * A * D[:, None, :]).abs().amax(-1)
        D = D / torch.sqrt(torch.clamp(rn, min=1e-10))
    As = D[:, :, None] * A * D[:, None, :]
    K_s = torch.stack([As[:, s * nz:(s + 1) * nz, s * nz:(s + 1) * nz]
                       for s in range(S)], 1)
    ev_s = torch.stack([As[:, s * nz + r, (s + 1) * nz + c]
                        for s in range(S - 1)], 1)
    d = D.reshape(B, S, nz)
    return K_s, ev_s, rhs * d, d


CASES = [("nz56", torch.float32, 3), ("nz56", torch.float32, 4),
         ("nz72", torch.float32, 3), ("nz72", torch.float32, 4),
         ("nav44", torch.float64, 3), ("nav44", torch.float64, 4)]


@pytest.mark.parametrize("width,dtype,iters", CASES)
def test_ruiz_matches_dense_formulation(width, dtype, iters):
    """K_s, ev_s, rhs_s and d within DENSE_RTOL of the dense
    formulation's, entry by entry, over 3 lanes of 6 stages."""
    pat, nz = _pattern(width)
    K, ev, rhs = _system(3, 6, nz, len(pat.rows), dtype)
    got = bk.ruiz_se(K, ev, rhs, pat, iters)
    want = _dense_ruiz(K, ev, rhs, pat, iters)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=DENSE_RTOL, atol=0)


@pytest.mark.parametrize("width,dtype,iters", CASES[::3] + CASES[-1:])
def test_ruiz_nan_lane(width, dtype, iters):
    """A NaN in one lane's K stays in that lane: the other lanes are
    bit for bit what they are without it.  In the lane, a sweep carries
    it one stage further, so d is NaN at the NaN's stage and bit for bit
    the clean lane's from ``iters`` stages away on."""
    pat, nz = _pattern(width)
    S, s0 = 12, 2
    K, ev, rhs = _system(3, S, nz, len(pat.rows), dtype, seed=1)
    clean = bk.ruiz_se(K, ev, rhs, pat, iters)
    K[1, s0, 5, 7] = float("nan")
    got = bk.ruiz_se(K, ev, rhs, pat, iters)
    for g, c in zip(got, clean):
        assert torch.equal(g[[0, 2]], c[[0, 2]])
    d = got[3][1]
    assert bool(torch.isnan(d[s0]).all())
    assert torch.equal(d[s0 + iters:], clean[3][1, s0 + iters:])


def _old_ruiz(K, ev, rhs, rows_t, cols_t, iters):
    """``ipm._ruiz``'s single-apply branch as it read before it called
    ``ruiz_se``, kept here verbatim as the reference of the move."""
    def coupling_row_norms(rn, aev_s):
        idx_r = rows_t.expand_as(aev_s)
        idx_c = cols_t.expand_as(aev_s)
        rn = rn.clone()
        rn[:, :-1] = rn[:, :-1].scatter_reduce(2, idx_r, aev_s, "amax",
                                               include_self=True)
        rn[:, 1:] = rn[:, 1:].scatter_reduce(2, idx_c, aev_s, "amax",
                                             include_self=True)
        return rn

    aK = torch.abs(K)
    aev = torch.abs(ev)
    dsc = torch.ones_like(rhs)
    for _ in range(iters):
        rn = (aK * dsc[:, :, None, :]).amax(-1) * dsc
        aev_s = aev * dsc[:, :-1, rows_t] * dsc[:, 1:, cols_t]
        rn = coupling_row_norms(rn, aev_s)
        dsc = dsc / torch.sqrt(torch.clamp(rn, min=1e-10))
    K_s = K * dsc[:, :, :, None] * dsc[:, :, None, :]
    ev_s = ev * dsc[:, :-1, rows_t] * dsc[:, 1:, cols_t]
    return K_s, ev_s, rhs * dsc, dsc


@pytest.mark.parametrize("route", ["f32", "mixed"])
def test_ipm_ruiz_calls_wrapper_bitwise(route, monkeypatch):
    """Two turns of a B=2 parking batch at N=10: ``_ruiz`` calls
    ``ruiz_se`` once a turn, with the configuration's sweeps, and each
    call returns what the former expression gives on its inputs, bit
    for bit."""
    dtype = torch.float32 if route == "f32" else torch.float64
    cfg = (f32_solver_config if route == "f32" else mixed_solver_config)(
        max_iter=2)
    base = reverse_parking_spec(N=10, Ts=2.4, dtype=dtype, device="cpu")
    specs = tspec.stack([base, dataclasses.replace(
        base, x0=base.x0 + torch.tensor([0.2, -0.1, 0.0, 0.0],
                                        dtype=dtype))])
    calls = []
    real = bk.ruiz_se

    def recording(K, ev, rhs, pat, iters):
        out = real(K, ev, rhs, pat, iters)
        calls.append(((K, ev, rhs, pat, iters), out))
        return out

    monkeypatch.setattr(bk, "ruiz_se", recording)
    state, step, _, _ = ipm._make_step(specs, cfg)
    for _ in range(2):
        state = step(state)
    assert len(calls) == 2
    for (K, ev, rhs, pat, iters), out in calls:
        assert iters == cfg.ruiz_iters and K.dtype == dtype
        ix = pat.index(K.device)
        want = _old_ruiz(K, ev, rhs, ix["rows"], ix["cols"], iters)
        for g, w in zip(out, want):
            assert torch.equal(g, w)


def test_ipm_ruiz_pow2_takes_d_from_wrapper(monkeypatch):
    """With ``ruiz_pow2`` set, ``_ruiz`` takes d from ``ruiz_se`` (the
    kernel on the card) once a turn, and that d is the former
    expression's, which the branch then rounds to powers of two."""
    cfg = f32_solver_config(max_iter=2, ruiz_pow2=True)
    base = reverse_parking_spec(N=10, Ts=2.4, dtype=torch.float32,
                                device="cpu")
    specs = tspec.stack([base, dataclasses.replace(
        base, x0=base.x0 + torch.tensor([0.2, -0.1, 0.0, 0.0]))])
    calls = []
    real = bk.ruiz_se

    def recording(K, ev, rhs, pat, iters):
        out = real(K, ev, rhs, pat, iters)
        calls.append(((K, ev, rhs, pat, iters), out))
        return out

    monkeypatch.setattr(bk, "ruiz_se", recording)
    state, step, _, _ = ipm._make_step(specs, cfg)
    for _ in range(2):
        state = step(state)
    assert len(calls) == 2
    for (K, ev, rhs, pat, iters), out in calls:
        ix = pat.index(K.device)
        want = _old_ruiz(K, ev, rhs, ix["rows"], ix["cols"], iters)[3]
        assert torch.equal(out[3], want)
    assert bool(torch.isfinite(state.W).all())
