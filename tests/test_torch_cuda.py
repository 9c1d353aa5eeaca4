"""obca_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

A CUDA kernel has no interpret mode, so every test here needs a GPU and
skips without one.  This file imports neither JAX nor obca_tpu, so it
also runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from obca_torch.solver import kkt
from obca_torch.solver.kernels import blocktri_dense as bd
from obca_torch.solver.kernels import blocktri_se as bk
from obca_torch.solver.kernels import probes

S, NW, NC, B = 9, 6, 5, 3
NZ = NW + NC
ROWS = np.array([6, 7, 8, 9, 4, 4, 5, 2, 0, 1, 3])
COLS = np.array([0, 1, 2, 3, 6, 7, 8, 2, 9, 10, 0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    blocks = []
    for _ in range(B * S):
        M = rng.standard_normal((NW, NW))
        A = M @ M.T / NW + 2.0 * np.eye(NW)
        Q = rng.standard_normal((NC, NC))
        D = -(Q @ Q.T / NC + np.eye(NC))
        J = rng.standard_normal((NC, NW))
        blocks.append(np.block([[A, J.T], [J, D]]))
    K = np.stack(blocks).reshape(B, S, NZ, NZ)
    ev = 0.3 * rng.standard_normal((B, S - 1, len(ROWS)))
    reg = np.tile(np.concatenate([np.full(NW, 1e-4), np.full(NC, -1e-4)]),
                  (B, 1))
    r = rng.standard_normal((B, S, NZ))
    return K, ev, reg, r


def _f32(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _on_card(a, dev, offset=False):
    """a as a contiguous float32 tensor on dev; with offset, 4 bytes past
    a 16-byte boundary (contiguous, not 16-byte aligned)."""
    if not offset:
        return _f32(a, dev)
    buf = torch.empty(a.size + 1, device=dev)
    t = buf[1:].view(a.shape)
    t.copy_(torch.as_tensor(a, dtype=torch.float32))
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.gpu
def test_cuda_kernels_match_plain(system, cuda):
    """Relative error <= 1e-4 in float32, each kernel fed the same
    inputs as its plain version; one launch counted per call."""
    K, ev, reg, r = (_f32(a, cuda) for a in system)
    pat = bk.CouplingPattern.of(ROWS, COLS)
    before = dict(bk.launches)
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    p, Ap = bk.bwd_matvec_se(Wc, y, K, ev, pat)
    torch.cuda.synchronize()
    Sinv_p, Wc_p = bk.factor_se_plain(K, ev, reg, pat)
    y_p = bk.fwd_se_plain(Sinv, ev, r, pat)
    p_p, Ap_p = bk.bwd_matvec_se_plain(Wc, y, K, ev, pat)
    for got, want in ((Sinv, Sinv_p), (Wc, Wc_p), (y, y_p), (p, p_p),
                      (Ap, Ap_p)):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-4
    for name in ("factor_se", "fwd_se", "bwd_matvec_se"):
        assert bk.launches[name] == before[name] + 1


@pytest.mark.gpu
def test_cuda_wrappers_refuse_bad_inputs(system, cuda):
    K, ev, reg, _ = system
    pat = bk.CouplingPattern.of(ROWS, COLS)
    K64 = torch.tensor(K, device=cuda)
    ev64 = torch.tensor(ev, device=cuda)
    reg64 = torch.tensor(reg, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bk.factor_se(K64, ev64, reg64, pat)
    with pytest.raises(ValueError, match="contiguous"):
        bk.factor_se(K64.float().transpose(-1, -2), ev64.float(),
                     reg64.float(), pat)
    with pytest.raises(ValueError, match="outside"):
        bk.factor_se(K64.float(), ev64.float(), reg64.float(),
                     bk.CouplingPattern.of(ROWS, COLS + NZ))
    with pytest.raises(ValueError, match="shape"):
        bk.fwd_se(K64.float(), ev64.float()[:, 1:].contiguous(),
                  torch.zeros((B, S, NZ), device=cuda), pat)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _interchange_system(nz, S, B, kind, seed=0):
    """Stage blocks that need row interchanges, numpy f64: quasidefinite
    blocks (primal part nw = ceil(nz / 2)) whose regularized leading
    diagonal entry is 1e-8 ("tiny_lead"), or whose rows are randomly
    permuted ("permuted"); a random duplicate-free coupling pattern of
    11 entries.  Condition numbers stay below 10 (float64 check)."""
    rng = np.random.default_rng(seed)
    nw = (nz + 1) // 2
    nc = nz - nw
    M = rng.standard_normal((B, S, nw, nw))
    A = M @ np.swapaxes(M, -1, -2) / nw + 2.0 * np.eye(nw)
    Q = rng.standard_normal((B, S, nc, nc))
    D = -(Q @ np.swapaxes(Q, -1, -2) / nc + np.eye(nc))
    J = rng.standard_normal((B, S, nc, nw))
    K = np.concatenate([np.concatenate([A, np.swapaxes(J, -1, -2)], -1),
                        np.concatenate([J, D], -1)], -2)
    reg = np.tile(np.concatenate([np.full(nw, 1e-4), np.full(nc, -1e-4)]),
                  (B, 1))
    if kind == "tiny_lead":
        K[:, :, 0, 0] = 1e-8 - reg[:, None, 0]
    else:
        for b in range(B):
            for s in range(S):
                K[b, s] = K[b, s][rng.permutation(nz)]
    flat = rng.choice(nz * nz, size=11, replace=False)
    pat = bk.CouplingPattern.of(flat // nz, flat % nz)
    ev = 0.3 * rng.standard_normal((B, S - 1, len(flat)))
    r = rng.standard_normal((B, S, nz))
    return K, ev, reg, r, pat


@pytest.mark.gpu
@pytest.mark.parametrize("nz,S,B,kind", [
    (11, 1, 3, "tiny_lead"), (11, 7, 1, "permuted"),
    (56, 2, 1, "tiny_lead"), (56, 9, 2, "permuted"),
    (bk.NZ_MAX, 5, 1, "permuted"), (bk.NZ_MAX, 2, 2, "tiny_lead")])
def test_cuda_factor_fwd_se_with_interchanges(nz, S, B, kind, cuda):
    """factor_se and fwd_se within 1e-4 relative of their plain versions
    in float32 on blocks that need row interchanges (the implicit pivot
    permutation), at nz = 11, 56 and the cap, S = 1, 2 and S that are
    not multiples of fwd_se's ring of 4 stage buffers, and B = 1."""
    K, ev, reg, r, pat = _interchange_system(nz, S, B, kind)
    K, ev, reg, r = (_f32(a, cuda) for a in (K, ev, reg, r))
    before = dict(bk.launches)
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    torch.cuda.synchronize()
    Sinv_p, Wc_p = bk.factor_se_plain(K, ev, reg, pat)
    assert _rel(Sinv, Sinv_p) <= 1e-4
    if S > 1:
        assert _rel(Wc, Wc_p) <= 1e-4
    assert _rel(y, bk.fwd_se_plain(Sinv, ev, r, pat)) <= 1e-4
    for name in ("factor_se", "fwd_se"):
        assert bk.launches[name] == before[name] + 1


@pytest.mark.gpu
def test_cuda_factor_fwd_se_refuse_nz_above_cap(cuda):
    """An nz above NZ_MAX raises on the card in each structured-coupling
    kernel (factor_se, fwd_se, bwd_matvec_se, bwd_se) and in the dense
    factor_dense, fwd_dense and bwd_dense: no fallback, no launch."""
    nz = bk.NZ_MAX + 1
    pat = bk.CouplingPattern.of([0], [1])
    K = torch.zeros((1, 2, nz, nz), device=cuda)
    ev = torch.zeros((1, 1, 1), device=cuda)
    y = torch.zeros((1, 2, nz), device=cuda)
    Wc = torch.zeros((1, 1, nz, 1), device=cuda)
    E = torch.zeros((1, 1, nz, nz), device=cuda)
    before = dict(bk.launches)
    with pytest.raises(ValueError, match="cap"):
        bk.factor_se(K, ev, torch.zeros((1, nz), device=cuda), pat)
    with pytest.raises(ValueError, match="cap"):
        bk.fwd_se(K, ev, y, pat)
    with pytest.raises(ValueError, match="cap"):
        bk.bwd_matvec_se(Wc, y, K, ev, pat)
    with pytest.raises(ValueError, match="cap"):
        bk.bwd_se(Wc, y, pat)
    with pytest.raises(ValueError, match="cap"):
        bd.factor_dense(K, E)
    with pytest.raises(ValueError, match="cap"):
        bd.fwd_dense(K, E, y)
    with pytest.raises(ValueError, match="cap"):
        bd.bwd_dense(E, y)
    assert bk.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("nz,S,B,kind,r_offset", [
    (11, 1, 3, "tiny_lead", False), (11, 7, 1, "permuted", False),
    (56, 1, 1, "permuted", False), (56, 2, 1, "tiny_lead", False),
    (56, 9, 3, "permuted", False), (56, 7, 3, "tiny_lead", True),
    (bk.NZ_MAX, 5, 1, "permuted", False),
    (bk.NZ_MAX, 2, 3, "tiny_lead", False)])
def test_cuda_factor_fwd_dense_with_interchanges(nz, S, B, kind, r_offset,
                                                 cuda):
    """factor_dense (Sinv and W), fwd_dense and then bwd_dense within
    1e-4 relative of their plain versions in float32, on a dense coupling
    block (0.3 N(0, 1) / sqrt(nz)) and stage blocks that need row
    interchanges: nz = 11 (the 4-byte route), 56 and the cap; S = 1, 2
    and S that are not multiples of the rings of 4 (fwd_dense) and 8
    (bwd_dense) stage buffers; B = 1 and 3; r, and y for bwd_dense, at a
    4-byte offset, which takes the 4-byte route.  One launch counted per
    call."""
    K, _, reg, r, _ = _interchange_system(nz, S, B, kind)
    rng = np.random.default_rng(2)
    E = 0.3 * rng.standard_normal((B, S - 1, nz, nz)) / np.sqrt(nz)
    K = _f32(K + reg[:, None, :, None] * np.eye(nz), cuda)
    E = _f32(E, cuda)
    r = _on_card(r, cuda, r_offset)
    before = dict(bk.launches)
    Sinv, W = bd.factor_dense(K, E)
    y = bd.fwd_dense(Sinv, E, r)
    y_t = _on_card(y.cpu().numpy(), cuda, r_offset)
    x = bd.bwd_dense(W, y_t)
    torch.cuda.synchronize()
    Sinv_p, W_p = bd.factor_dense_plain(K, E)
    assert _rel(Sinv, Sinv_p) <= 1e-4
    if S > 1:
        assert _rel(W, W_p) <= 1e-4
    assert _rel(y, bd.fwd_dense_plain(Sinv, E, r)) <= 1e-4
    assert _rel(x, bd.bwd_dense_plain(W, y_t)) <= 1e-4
    for name in ("factor_dense", "fwd_dense", "bwd_dense"):
        assert bk.launches[name] == before[name] + 1


def _bwd_system(nz, S, B, kind, seed=0):
    """Inputs of the backward kernels, numpy f64: Wc [B, S-1, nz, C]
    (scaled so that p stays of order one over the stages), y [B, S, nz],
    K [B, S, nz, nz], ev [B, S-1, nnz], and the pattern.  "window": 11
    distinct entries in rows 0-5 and the last 6 columns, so that some
    rows and columns hold several entries and others none; "wide": every
    column coupled (C = nz, wider than the sweep's unrolled row, and too
    wide for the kernels' larger rings of stage buffers) and row 0 three
    times more."""
    rng = np.random.default_rng(seed)
    if kind == "wide":
        rows = np.concatenate([np.arange(nz), [0, 0, 0]])
        cols = np.concatenate([(5 * np.arange(nz) + 1) % nz, [3, 5, 7]])
    else:
        flat = rng.choice(36, size=11, replace=False)
        rows, cols = flat // 6, nz - 6 + flat % 6
    pat = bk.CouplingPattern.of(rows, cols)
    C = len(pat.ucols)
    Wc = 0.5 * rng.standard_normal((B, S - 1, nz, C)) / np.sqrt(C)
    y = rng.standard_normal((B, S, nz))
    K = rng.standard_normal((B, S, nz, nz))
    ev = 0.3 * rng.standard_normal((B, S - 1, len(rows)))
    return Wc, y, K, ev, pat


@pytest.mark.gpu
@pytest.mark.parametrize("nz,S,B,kind,y_offset", [
    (11, 1, 3, "window", False), (11, 17, 1, "window", False),
    (56, 1, 1, "window", False), (56, 2, 3, "window", False),
    (56, 9, 1, "window", False), (56, 17, 3, "window", False),
    (56, 7, 3, "window", True), (bk.NZ_MAX, 7, 1, "window", False),
    (bk.NZ_MAX, 9, 3, "wide", False)])
def test_cuda_bwd_kernels_match_plain(nz, S, B, kind, y_offset, cuda):
    """bwd_matvec_se (p and Ap) and bwd_se within 1e-4 relative of their
    plain versions in float32 (the sums run in another order): nz = 11
    (the scalar route), 56 and the cap; S = 1 (no Wc stage), 2 and S
    whose step counts are not multiples of the rings of 8 (bwd_matvec_se)
    and 16 (bwd_se) stage buffers; B = 1 and 3; y at a 4-byte offset
    (contiguous, not 16-byte aligned), which takes the scalar route.  One
    launch counted per call."""
    Wc, y, K, ev, pat = _bwd_system(nz, S, B, kind)
    Wc, K, ev = (_f32(a, cuda) for a in (Wc, K, ev))
    y_t = _on_card(y, cuda, y_offset)
    before = dict(bk.launches)
    p, Ap = bk.bwd_matvec_se(Wc, y_t, K, ev, pat)
    q = bk.bwd_se(Wc, y_t, pat)
    torch.cuda.synchronize()
    p_p, Ap_p = bk.bwd_matvec_se_plain(Wc, y_t, K, ev, pat)
    assert _rel(p, p_p) <= 1e-4
    assert _rel(Ap, Ap_p) <= 1e-4
    assert _rel(q, bk.bwd_se_plain(Wc, y_t, pat)) <= 1e-4
    for name in ("bwd_matvec_se", "bwd_se"):
        assert bk.launches[name] == before[name] + 1


@pytest.fixture(scope="module")
def dense_e():
    """A genuinely dense coupling block per stage, 0.3 N(0, 1) / sqrt(nz)."""
    rng = np.random.default_rng(1)
    return 0.3 * rng.standard_normal((B, S - 1, NZ, NZ)) / np.sqrt(NZ)


@pytest.mark.gpu
def test_cuda_mixed_solve_kernels_match_plain(system, cuda):
    """bwd_se and solve_se (fwd_se then bwd_se) within 1e-4 relative of
    their plain versions in float32; one bwd_se launch per call."""
    K, ev, reg, r = (_f32(a, cuda) for a in system)
    pat = bk.CouplingPattern.of(ROWS, COLS)
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    before = dict(bk.launches)
    p = bk.bwd_se(Wc, y, pat)
    x = bk.solve_se(Sinv, Wc, ev, r, pat)
    torch.cuda.synchronize()
    assert _rel(p, bk.bwd_se_plain(Wc, y, pat)) <= 1e-4
    assert _rel(x, bk.solve_se_plain(Sinv, Wc, ev, r, pat)) <= 1e-4
    assert bk.launches["bwd_se"] == before["bwd_se"] + 2
    assert bk.launches["fwd_se"] == before["fwd_se"] + 1


@pytest.mark.gpu
def test_cuda_dense_kernels_match_plain(system, dense_e, cuda):
    """factor_dense, fwd_dense and bwd_dense within 1e-4 relative of
    their plain versions in float32, on a dense coupling block."""
    K, _, reg, r = (_f32(a, cuda) for a in system)
    E = _f32(dense_e, cuda)
    K = (K + torch.diag_embed(reg)[:, None]).contiguous()
    before = dict(bk.launches)
    Sinv, W = bd.factor_dense(K, E)
    y = bd.fwd_dense(Sinv, E, r)
    x = bd.bwd_dense(W, y)
    torch.cuda.synchronize()
    Sinv_p, W_p = bd.factor_dense_plain(K, E)
    assert _rel(Sinv, Sinv_p) <= 1e-4
    assert _rel(W, W_p) <= 1e-4
    assert _rel(y, bd.fwd_dense_plain(Sinv, E, r)) <= 1e-4
    assert _rel(x, bd.bwd_dense_plain(W, y)) <= 1e-4
    for name in ("factor_dense", "fwd_dense", "bwd_dense"):
        assert bk.launches[name] == before[name] + 1


@pytest.mark.gpu
def test_cuda_mixed_kkt_solver_se_runs_bwd_se(system, cuda):
    """The mixed route on the card: f64 in, f64 out, through fwd_se and
    bwd_se (not the fused bwd_matvec_se), and as exact as on the CPU."""
    K, ev, reg, r = (torch.tensor(a, device=cuda) for a in system)
    solve = kkt.make_kkt_solver_se(NW, 4, torch.float32, torch.float64,
                                   ROWS, COLS)
    before = dict(bk.launches)
    d, lin = solve(K, ev, reg, r)
    torch.cuda.synchronize()
    assert d.dtype == torch.float64 and lin.dtype == torch.float64
    assert bk.launches["bwd_se"] == before["bwd_se"] + 4
    assert bk.launches["bwd_matvec_se"] == before["bwd_matvec_se"]
    d_cpu, _ = solve(*(t.cpu() for t in (K, ev, reg, r)))
    assert _rel(d.cpu(), d_cpu) <= 1e-8
    assert float(lin.max()) <= 1e-8


@pytest.mark.gpu
def test_cuda_dense_kernels_refuse_float64(system, dense_e, cuda):
    """The dense kernels take float32 only on the card: a float64 input
    raises TypeError, and so does make_kkt_solver(f64, f64)."""
    K, _, reg, r = (torch.tensor(a, device=cuda) for a in system)
    E = torch.tensor(dense_e, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bd.factor_dense(K, E)
    with pytest.raises(TypeError, match="float32"):
        bd.fwd_dense(K, E, r)
    with pytest.raises(TypeError, match="float32"):
        bd.bwd_dense(E, r)
    solve = kkt.make_kkt_solver(NW, 4, torch.float64, torch.float64)
    with pytest.raises(TypeError, match="float32"):
        solve(K, E, reg, r)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [
    (3, True), (4096, False), (4096, True), (1_000_003, False),
    (1_000_003, True)])
def test_cuda_probe_kernels_match_plain(n, offset, cuda):
    """The kernel bench's probes against their plain versions: the stream
    kernel equals x + 1 exactly, the FMA probe is within 2 units in the
    last place at every element (the plain version rounds each step once,
    as the kernel's fused multiply-add does; without the FMAs the error
    is tens of units or more); n with
    n % 4 != 0 (the float4 route's scalar tail) and x at a 4-byte offset
    (the scalar route).  One launch counted per call."""
    x = _on_card(np.random.default_rng(n).standard_normal(n), cuda, offset)
    before = dict(bk.launches)
    s = probes.stream_add_one(x)
    f = probes.fma_probe(x)
    torch.cuda.synchronize()
    assert torch.equal(s, probes.stream_add_one_plain(x))
    assert probes.max_ulps(f, probes.fma_probe_plain(x)) <= 2
    for name in ("stream_add_one", "fma_probe"):
        assert bk.launches[name] == before[name] + 1
