"""obca_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

A CUDA kernel has no interpret mode, so every test here needs a GPU and
skips without one.  This file imports neither JAX nor obca_tpu, so it
also runs where only the port is installed, with the full-size paths
of ``tests/test_torch_card_paths.py``:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py \\
        tests/test_torch_card_paths.py
"""

import numpy as np
import pytest
import torch

import full_size_batches as fsb
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


FULL_SIZE = ["nz56", "nz72", "nz72_permuted", "nz72_tiny_lead"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["small", *FULL_SIZE])
def test_cuda_kernels_match_plain(case, system, cuda):
    """Relative error <= 1e-4 in float32 of factor_se, fwd_se,
    bwd_matvec_se and bwd_se, each kernel fed the same inputs as its
    plain version (the outputs of the kernel before it); one launch
    counted per call.  On the small system and at the main paths' shape
    (``full_size_batches.full_size_system``)."""
    if case == "small":
        K, ev, reg, r = system
        pat = bk.CouplingPattern.of(ROWS, COLS)
    else:
        K, ev, reg, r, pat, _ = fsb.full_size_system(case)
    K, ev, reg, r = (_f32(a, cuda) for a in (K, ev, reg, r))
    before = dict(bk.launches)
    Sinv, Wc = bk.factor_se(K, ev, reg, pat)
    y = bk.fwd_se(Sinv, ev, r, pat)
    p, Ap = bk.bwd_matvec_se(Wc, y, K, ev, pat)
    q = bk.bwd_se(Wc, y, pat)
    torch.cuda.synchronize()
    Sinv_p, Wc_p = bk.factor_se_plain(K, ev, reg, pat)
    y_p = bk.fwd_se_plain(Sinv, ev, r, pat)
    p_p, Ap_p = bk.bwd_matvec_se_plain(Wc, y, K, ev, pat)
    q_p = bk.bwd_se_plain(Wc, y, pat)
    for got, want in ((Sinv, Sinv_p), (Wc, Wc_p), (y, y_p), (p, p_p),
                      (Ap, Ap_p), (q, q_p)):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-4
    for name in ("factor_se", "fwd_se", "bwd_matvec_se", "bwd_se"):
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
    diagonal entry is 1e-8 ("tiny_lead"), whose rows are randomly
    permuted ("permuted"), or whose rows are rolled by 11 ("crossed":
    each column's diagonal entry moves into the rows of another panel of
    8 columns, so that the pivots' row interchanges cross the panels of
    the elimination); a random duplicate-free coupling pattern of 11
    entries.  Condition numbers stay below 10 (float64 check)."""
    rng = np.random.default_rng(seed)
    nw = (nz + 1) // 2
    K, reg = fsb.qd_blocks(rng, B, S, nw, nz - nw)
    if kind == "tiny_lead":
        K[:, :, 0, 0] = 1e-8 - reg[:, None, 0]
    elif kind == "crossed":
        K = np.roll(K, 11, axis=2)
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
    (64, 5, 1, "permuted"), (64, 2, 2, "tiny_lead"),
    (72, 9, 2, "permuted"), (72, 2, 1, "tiny_lead"),
    (75, 3, 2, "permuted"),
    (bk.NZ_MAX, 5, 1, "permuted"), (bk.NZ_MAX, 2, 2, "tiny_lead"),
    (44, 5, 2, "permuted"), (13, 3, 2, "permuted"), (13, 2, 1, "tiny_lead"),
    (8, 3, 2, "permuted"), (16, 4, 2, "tiny_lead"), (56, 3, 37, "permuted"),
    (56, 5, 2, "crossed"), (72, 3, 2, "crossed")])
def test_cuda_factor_fwd_se_with_interchanges(nz, S, B, kind, cuda):
    """factor_se and fwd_se within 1e-4 relative of their plain versions
    in float32 on blocks that need row interchanges (the implicit pivot
    permutation), at nz = 11, 56 and 64 (the instantiation for nz <= 64)
    and 72, 75 (odd: the 4-byte route) and the cap 128 (the one for
    64 < nz <= 128), S = 1, 2 and S that are not multiples of fwd_se's
    ring of 4 stage buffers, and B = 1.  The elimination takes its
    pivots in panels of 8: a last panel of fewer (nz = 44, 13, 75), whole
    panels only (8, 16: one and two), a rescue round's batch (B = 37),
    and interchanges across the panels ("crossed")."""
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
    """An nz above NZ_MAX (129) raises on the card in each
    structured-coupling kernel (factor_se, fwd_se, bwd_matvec_se, bwd_se)
    and in the dense factor_dense, fwd_dense and bwd_dense: no fallback,
    no launch."""
    nz = bk.NZ_MAX + 1
    assert nz == 129
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
    (64, 5, 1, "permuted", False), (64, 2, 3, "tiny_lead", False),
    (72, 9, 3, "permuted", False), (72, 7, 3, "tiny_lead", True),
    (75, 3, 2, "permuted", False),
    (bk.NZ_MAX, 5, 1, "permuted", False),
    (bk.NZ_MAX, 2, 3, "tiny_lead", False),
    (44, 3, 2, "permuted", False), (13, 3, 2, "permuted", False),
    (8, 2, 2, "tiny_lead", False), (16, 3, 2, "permuted", False),
    (56, 2, 37, "permuted", False), (56, 3, 2, "crossed", False),
    (72, 3, 2, "crossed", False)])
def test_cuda_factor_fwd_dense_with_interchanges(nz, S, B, kind, r_offset,
                                                 cuda):
    """factor_dense (Sinv and W), fwd_dense and then bwd_dense within
    1e-4 relative of their plain versions in float32, on a dense coupling
    block (0.3 N(0, 1) / sqrt(nz)) and stage blocks that need row
    interchanges: nz = 11 (the 4-byte route), 56, 64, then 72, 75 (the
    4-byte route) and the cap 128 of the wide instantiations; S = 1, 2
    and S that are not multiples of the rings of 4 (fwd_dense) and 8
    (bwd_dense) stage buffers; B = 1 and 3; r, and y for bwd_dense, at a
    4-byte offset, which takes the 4-byte route.  The elimination's
    panels of 8 pivots, as for factor_se: nz = 44, 13 (a last panel of
    fewer), 8, 16 (whole panels), B = 37 and "crossed" blocks.  One
    launch counted per call."""
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
    (56, 7, 3, "window", True), (64, 7, 1, "window", False),
    (64, 9, 3, "wide", False), (72, 9, 3, "window", False),
    (72, 17, 1, "wide", False), (72, 7, 3, "window", True),
    (bk.NZ_MAX, 7, 1, "window", False), (bk.NZ_MAX, 9, 3, "wide", False)])
def test_cuda_bwd_kernels_match_plain(nz, S, B, kind, y_offset, cuda):
    """bwd_matvec_se (p and Ap) and bwd_se within 1e-4 relative of their
    plain versions in float32 (the sums run in another order): nz = 11
    (the scalar route), 56, 64, and 72 and the cap 128 of the wide
    instantiations ("wide" at 72 and 128 takes the ring of 3, at 128
    with K_{s+1} read from device memory); S = 1 (no Wc stage), 2 and S
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
@pytest.mark.parametrize("case", ["small", *FULL_SIZE])
def test_cuda_dense_kernels_match_plain(case, system, dense_e, cuda):
    """factor_dense, fwd_dense and bwd_dense within 1e-4 relative of
    their plain versions in float32, on a dense coupling block: on the
    small system and at the main paths' shape
    (``full_size_batches.full_size_system``)."""
    if case == "small":
        (K, _, reg, r), E = system, dense_e
    else:
        K, _, reg, r, _, E = fsb.full_size_system(case)
    K, reg, r, E = (_f32(a, cuda) for a in (K, reg, r, E))
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
    (1_000_003, True), (100_002, True), (128 * 81 * 56 * 56, False)])
def test_cuda_probe_kernels_match_plain(n, offset, cuda):
    """The kernel bench's probes against their plain versions: the stream
    kernel equals x + 1 exactly, the FMA probe is within 2 units in the
    last place at every element (the plain version rounds each step once,
    as the kernel's fused multiply-add does; without the FMAs the error
    is tens of units or more); n with
    n % 4 != 0 (the float4 route's scalar tail) and x at a 4-byte offset
    (the scalar route); the kernel bench's [128, 81, 56, 56] array.  One
    launch counted per call."""
    x = _on_card(np.random.default_rng(n).standard_normal(n), cuda, offset)
    before = dict(bk.launches)
    s = probes.stream_add_one(x)
    f = probes.fma_probe(x)
    torch.cuda.synchronize()
    assert torch.equal(s, probes.stream_add_one_plain(x))
    assert probes.max_ulps(f, probes.fma_probe_plain(x)) <= 2
    for name in ("stream_add_one", "fma_probe"):
        assert bk.launches[name] == before[name] + 1


@pytest.mark.gpu
def test_cuda_nav_mixed_solve_matches_cpu(cuda):
    """The navigation family on the card under ``mixed_solver_config``
    (f32 factor: ``factor_se``, ``fwd_se``, ``bwd_se``) at N=40: it
    converges, launches the mixed route's kernels and not
    ``bwd_matvec_se``, and its controls are within 1e-6 of the float64
    solve of the same spec on the CPU."""
    from obca_torch import SolverConfig, mixed_solver_config, nav

    spec = nav.nav_spec(N=40, vertex_lists=fsb.NAV_VERTS, device=cuda)
    bk.reset_launches()
    res = nav.solve(spec, mixed_solver_config(max_iter=150))
    launches = dict(bk.launches)
    ref = nav.solve(nav.nav_spec(N=40, vertex_lists=fsb.NAV_VERTS,
                                 device="cpu"), SolverConfig(max_iter=150))
    assert int(res.status) == int(ref.status) == 0
    assert min(launches["factor_se"], launches["fwd_se"],
               launches["bwd_se"]) > 0
    assert launches["bwd_matvec_se"] == 0
    np.testing.assert_allclose(res.U.cpu().numpy(), ref.U.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
def test_cuda_nav_float64_factor_refused(cuda):
    """A nav solve asking for a float64 factor on the card raises, as a
    parking solve does; nothing falls back to the CPU."""
    from obca_torch import SolverConfig, nav

    spec = nav.nav_spec(N=10, vertex_lists=fsb.NAV_VERTS, device=cuda)
    with pytest.raises(TypeError):
        nav.solve(spec, SolverConfig(max_iter=5))


def _ruiz_pattern(width):
    """(coupling pattern, nz) of the small system, of it at the cap nz =
    NZ_MAX, or of a benchmark configuration's layout: parking (nz =
    56), the cluttered lot (nz = 72), nav (nz = 44)."""
    from obca_torch import nav, nlp, reverse_parking_spec

    if width in ("small", "cap"):
        return (bk.CouplingPattern.of(ROWS, COLS),
                NZ if width == "small" else bk.NZ_MAX)
    if width == "nav44":
        L = nav.layout_of(nav.nav_spec(N=4, vertex_lists=fsb.NAV_VERTS,
                                       device="cpu"))
        return bk.CouplingPattern.of(*nav.coupling_structure(L)), L.nz
    kw = dict(max_obs=4, max_faces=5) if width == "nz72" else {}
    L = nlp.layout_of(reverse_parking_spec(N=4, Ts=0.3, device="cpu", **kw))
    return bk.CouplingPattern.of(*nlp.coupling_structure(L)), L.nz


def _ruiz_system(B, S, nz, nnz, dtype, dev, offset=False):
    """A symmetric K [B, S, nz, nz] on the card whose rows span ten
    decades, with exact zeros and an all-zero row and column (the
    clamp's case); ev [B, S-1, nnz], rhs [B, S, nz].  For B > 1 lane
    B // 2 holds a NaN at stage S // 3.  With offset, K starts 4 bytes
    past a 16-byte boundary."""
    g = torch.Generator(dev).manual_seed(B * 1000 + nz)
    kw = dict(generator=g, device=dev, dtype=dtype)
    scale = 10.0 ** (10.0 * torch.rand((B, S, nz), **kw) - 5.0)
    A = torch.randn((B, S, nz, nz), **kw)
    A *= torch.rand((B, S, nz, nz), **kw) < 0.6
    K = (A + A.transpose(-1, -2)) * scale[..., None] * scale[..., None, :]
    del A
    K[:, :, 3] = 0.0
    K[:, :, :, 3] = 0.0
    if B > 1:
        K[B // 2, S // 3, 5, 7] = float("nan")
    if offset:
        buf = torch.empty(K.numel() + 1, device=dev, dtype=dtype)
        buf[1:].view(K.shape).copy_(K)
        K = buf[1:].view(K.shape)
    ev = torch.randn((B, S - 1, nnz), **kw) * 10.0 ** (
        6.0 * torch.rand((B, S - 1, nnz), **kw) - 3.0)
    return K, ev, torch.randn((B, S, nz), **kw)


def _same_bits(a, b):
    """Equal bit for bit (signed zeros included), NaN where the other is
    NaN whatever its payload."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    as_int = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.masked_fill(nan, 0).view(as_int),
                       b.masked_fill(nan, 0).view(as_int))


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [3, 4])
@pytest.mark.parametrize("B,S,width,dtype,offset", [
    (128, 81, "nz56", torch.float32, False),
    (1024, 81, "nz56", torch.float32, False),
    (128, 81, "nz72", torch.float32, False),
    (128, 61, "nav44", torch.float64, False),
    (1, 81, "nz56", torch.float32, False),
    (3, 9, "small", torch.float32, False),
    (3, 9, "small", torch.float64, False),
    (4, 9, "nz56", torch.float32, True),
    (2, 5, "cap", torch.float32, False),
    (2, 5, "cap", torch.float64, False)])
def test_cuda_ruiz_matches_plain(B, S, width, dtype, offset, iters, cuda):
    """``ruiz_se`` equals its plain version on the card bit for bit in
    all four outputs (K_s, ev_s, rhs_s, d), a NaN lane included (B > 1),
    at the benchmark's shapes: parking at B = 128, 1024 and 1, the
    cluttered lot, nav in float64; on the scalar-load routes: nz = 11
    (rows of 44 and 88 bytes) and an unaligned K; and at nz = NZ_MAX,
    where a float64 block takes a ring of one buffer.  One launch
    counted per call."""
    pat, nz = _ruiz_pattern(width)
    K, ev, rhs = _ruiz_system(B, S, nz, len(pat.rows), dtype, cuda, offset)
    before = bk.launches["ruiz_se"]
    got = bk.ruiz_se(K, ev, rhs, pat, iters)
    torch.cuda.synchronize()
    assert bk.launches["ruiz_se"] == before + 1
    want = bk.ruiz_se_plain(K, ev, rhs, pat, iters)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _same_bits(g, w)
    if B > 1:
        assert bool(torch.isnan(got[3][B // 2, S // 3]).all())
        assert bool(torch.isfinite(got[3][B // 2 - 1]).all())


@pytest.mark.gpu
def test_cuda_ruiz_refuses_bad_inputs(cuda):
    """``ruiz_se`` on the card takes float32 or float64 only, one dtype
    for all three inputs, the shapes [B, S, nz, nz], [B, S-1, nnz],
    [B, S, nz], contiguous tensors and nz <= NZ_MAX; it raises on
    anything else and launches nothing."""
    pat, nz = _ruiz_pattern("small")
    K, ev, rhs = _ruiz_system(3, 9, nz, len(pat.rows), torch.float32, cuda)
    before = bk.launches["ruiz_se"]
    with pytest.raises(TypeError, match="float32 or float64"):
        bk.ruiz_se(K.half(), ev.half(), rhs.half(), pat, 3)
    with pytest.raises(TypeError, match="float32"):
        bk.ruiz_se(K, ev.double(), rhs, pat, 3)
    with pytest.raises(ValueError, match="shape"):
        bk.ruiz_se(K, ev[:, 1:].contiguous(), rhs, pat, 3)
    with pytest.raises(ValueError, match="shape"):
        bk.ruiz_se(K[:, :, 1:].contiguous(), ev, rhs, pat, 3)
    with pytest.raises(ValueError, match="contiguous"):
        bk.ruiz_se(K.transpose(-1, -2), ev, rhs, pat, 3)
    with pytest.raises(ValueError, match="NZ_MAX"):
        big = bk.NZ_MAX + 4
        bk.ruiz_se(torch.zeros((1, 2, big, big), device=cuda),
                   torch.zeros((1, 1, len(pat.rows)), device=cuda),
                   torch.zeros((1, 2, big), device=cuda), pat, 3)
    assert bk.launches["ruiz_se"] == before


def _random_qd(rng, B, S, nw, nc):
    """A batch of well-conditioned quasidefinite block-tridiagonal
    systems (float64 numpy)."""
    nz = nw + nc
    R = rng.standard_normal((B, S, nw, nw))
    A = R @ np.swapaxes(R, -1, -2) / nw + np.eye(nw)
    Q = rng.standard_normal((B, S, nc, nc))
    D = -(Q @ np.swapaxes(Q, -1, -2) / nc + np.eye(nc))
    J = rng.standard_normal((B, S, nc, nw))
    K = np.concatenate([np.concatenate([A, np.swapaxes(J, -1, -2)], -1),
                        np.concatenate([J, D], -1)], -2)
    E = 0.2 * np.sqrt(13.0 / nz) * rng.standard_normal((B, S - 1, nz, nz))
    return K, E, rng.standard_normal((B, S, nz))


CR_SIZES = (81, 321, 641)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nw,nc,tol_f64", [
    (4, 33, 7, 6, 1e-10), *[(128, S, 31, 25, 1e-8) for S in CR_SIZES]])
def test_cuda_cyclic_matches_plain(B, S, nw, nc, tol_f64, cuda):
    """Cyclic reduction on the card: float64 within ``tol_f64`` relative
    of the plain sequential blocktri on the CPU, float32 within 1e-4 of
    the dense kernels (which launch); small, and at the main path's
    width (nz = 56, B = 128) over S = 81, 321 and 641, where the systems
    are those of ``bench_cyclic.main(31, 25, 128, (81, 321, 641))``: its
    ``random_qd`` draws from one ``default_rng(0)``, S after S."""
    from obca_torch.solver import blocktri, cyclic
    from obca_torch.tools import bench_cyclic

    if B == 128:
        rng = np.random.default_rng(0)
        for s in CR_SIZES[:CR_SIZES.index(S) + 1]:
            K, E, r = bench_cyclic.random_qd(rng, s, nw, nc, B)
    else:
        K, E, r = _random_qd(np.random.default_rng(5), B, S, nw, nc)
    Kc, Ec, rc = (torch.tensor(a, device=cuda) for a in (K, E, r))
    x = cyclic.solve(cyclic.factor(Kc, Ec, nw), rc).cpu()
    Kh, Eh, rh = (torch.tensor(a) for a in (K, E, r))
    x_ref = blocktri.solve(blocktri.factor(Kh, Eh, nw), rh)
    assert float((x - x_ref).abs().max() / x_ref.abs().max()) <= tol_f64
    K32, E32, r32 = (t.float().contiguous() for t in (Kc, Ec, rc))
    x32 = cyclic.solve(cyclic.factor(K32, E32, nw), r32)
    before = dict(bk.launches)
    Sinv, W = bd.factor_dense(K32, E32)
    xd = bd.solve_dense(Sinv, W, E32, r32)
    torch.cuda.synchronize()
    assert float((x32 - xd).abs().max() / xd.abs().max()) <= 1e-4
    for name in ("factor_dense", "fwd_dense", "bwd_dense"):
        assert bk.launches[name] == before[name] + 1


@pytest.mark.gpu
def test_cuda_solve_sharded_world_of_one(cuda):
    """solve_sharded over a one-rank NCCL group equals solve_batch on the
    same card bit for bit, and its all-reduced metrics are the local
    ones."""
    import dataclasses
    import socket

    from obca_torch import f32_solver_config, reverse_parking_spec
    from obca_torch import spec as tspec
    from obca_torch.parallel import distributed
    from obca_torch.parallel import mesh as mesh_mod
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric

    base = reverse_parking_spec(N=20, Ts=1.2, dtype=torch.float32,
                                device=cuda)
    specs = tspec.stack([dataclasses.replace(base, x0=base.x0 + torch.tensor(
        [s, 0.0, 0.0, 0.0], device=cuda)) for s in (-0.1, 0.0, 0.1, 0.2)])
    W0 = geometric.lattice_warm_start(specs, dtype=torch.float32)
    cfg = f32_solver_config(max_iter=55)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"localhost:{port}", num_processes=1,
                           process_id=0, local_device_ids=[0],
                           backend="nccl")
    try:
        res, met = mesh_mod.solve_sharded(
            specs, cfg, distributed.global_scenario_mesh(), W0)
    finally:
        torch.distributed.destroy_process_group()
    ref = ipm.solve_batch(specs, cfg, W0)
    assert torch.equal(res.U, ref.U) and torch.equal(res.iters, ref.iters)
    assert int(met["n_converged"]) == int(
        (ref.status == ipm.STATUS_CONVERGED).sum())
    assert float(met["max_err"]) == float(ref.err.max())


def test_mesh_and_nccl_refuse_without_a_gpu():
    """The default mesh takes every local card; without one it raises, and
    so does a NCCL process group: nothing falls back to the CPU."""
    from obca_torch.parallel import distributed
    from obca_torch.parallel import mesh as mesh_mod

    if torch.cuda.is_available():
        mesh = mesh_mod.scenario_mesh()
        assert [d.type for d in mesh.devices] == \
            ["cuda"] * torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="no GPU"):
        mesh_mod.scenario_mesh()
    with pytest.raises(RuntimeError, match="GPU"):
        distributed.initialize("localhost:1", num_processes=1, process_id=0,
                               backend="nccl")
    with pytest.raises(RuntimeError, match="GPU"):
        distributed.initialize("localhost:1", num_processes=1, process_id=0)


def _graph_batch(family, B, dev):
    """(specs, config, W0, problem module) of a benchmark-sized batch of
    B lanes: the main path's reverse parking at N=80 on the f32 route
    (``full_size_batches.main_path_batch`` and ``main_path_start``), the
    nav card test's batch on the mixed route (B = 128,
    ``full_size_batches.nav_batch``, cap 150, its default start), or the
    benchmark's cluttered lot ("topo": 4 obstacles of 5 faces, nz = 72,
    the wide kernels; starts x, y + uniform(-0.5, 0.5), heading +
    uniform(-0.15, 0.15); cap 70)."""
    import dataclasses

    from obca_torch import f32_solver_config, mixed_solver_config, nav
    from obca_torch import spec as tspec
    from obca_torch.solver import ipm
    from obca_torch.warmstart import geometric, lattice

    if family == "nav":
        assert B == fsb.B_NAV
        _, specs = fsb.nav_batch(dev)
        return specs, mixed_solver_config(max_iter=fsb.ITERS_NAV), None, nav
    if family == "parking":
        base, specs = fsb.main_path_batch(dev, B=B)
        return (specs, *fsb.main_path_start(base, specs), ipm.nlp)
    from portbench import harness
    from portbench.families import reverse_topo

    _, cfg, _, _ = harness.cell(harness.benchmark(),
                                "reverse_topo_sweep_b128")
    _, base = reverse_topo.base_spec(cfg, dev, torch.float32)
    gen = torch.Generator().manual_seed(15)
    shift = torch.zeros(B, 4, dtype=torch.float64)
    half = torch.tensor([0.5, 0.5, 0.15], dtype=torch.float64)
    shift[:, :3] = (2.0 * torch.rand(B, 3, generator=gen,
                                     dtype=torch.float64) - 1.0) * half
    specs = dataclasses.replace(tspec.stack([base] * B),
                                x0=base.x0 + shift.float().to(dev))
    lcfg = lattice.LatticeConfig.for_spec(base)
    W0 = geometric.lattice_warm_start(specs, dtype=torch.float32, cfg=lcfg,
                                      field=lattice.plan_field(base, lcfg))
    return specs, f32_solver_config(max_iter=70), W0, ipm.nlp


def _counted(monkeypatch, graphs, fn):
    """(fn's result, kernel launches, spans, counters) with the loop's
    turns replayed as graphs or not (``ipm._use_graphs`` patched)."""
    from obca_torch import trace
    from obca_torch.solver import ipm

    monkeypatch.setattr(ipm, "_use_graphs", lambda device: graphs)
    bk.reset_launches()
    trace.take()
    trace.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        trace.enable(False)
    spans, counters = trace.take()
    return out, dict(bk.launches), spans, counters


def _tensors(res):
    """The tensor fields of a result, nested dual states included."""
    out = {}
    for name, v in res._asdict().items():
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif v is not None and hasattr(v, "__dataclass_fields__"):
            out.update({f"{name}.{k}": getattr(v, k)
                        for k in v.__dataclass_fields__})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["parking", "nav", "topo"])
def test_cuda_graph_turns_match_eager(family, cuda, monkeypatch):
    """At B=128 (the cluttered lot at B=8, on the wide kernels) the
    solve that replays its turns as CUDA graphs equals the eager solve
    bit for bit (statuses, iterations, W, the duals), with the same
    kernel launches; it captures once and replays every turn but the
    first; a replayed turn holds one ``ipm.replay`` a graph and one
    ``kkt.factor`` a factorization (nav refactors for SOC).  The counter
    ``kernels.factor_se_wide`` counts every factorization at nz > 64 and
    none below, and nothing with the recorder off."""
    from obca_torch import trace
    from obca_torch.solver import ipm
    from obca_torch.solver.kernels import runtime

    specs, cfg, W0, prob = _graph_batch(family, 8 if family == "topo"
                                        else 128, cuda)

    def solve():
        return ipm.solve_batch(specs, cfg, W0, prob=prob)

    eager, l_e, _, c_e = _counted(monkeypatch, False, solve)
    graph, l_g, spans, c_g = _counted(monkeypatch, True, solve)
    for name, t in _tensors(eager).items():
        assert torch.equal(t, _tensors(graph)[name]), name
    assert l_g == l_e and l_g["factor_se"] > 0
    wide = prob.layout_of(specs).nz > runtime.NZ_NARROW
    assert wide == (family == "topo")
    for c in (c_e, c_g):
        assert c.get("kernels.factor_se_wide", 0) == \
            (l_g["factor_se"] if wide else 0)
    if wide:
        solve()
        assert trace.take() == ([], {})
    assert "ipm.graph_captures" not in c_e
    assert c_g["ipm.iters"] == c_e["ipm.iters"] > 1
    assert c_g["ipm.graph_captures"] == 1
    assert c_g["ipm.graph_replays"] == c_g["ipm.iters"] - 1
    n_factor = 2 if cfg.soc else 1
    turn = ["ipm.replay", "kkt.factor"] * n_factor + ["ipm.replay",
                                                      "ipm.sync"]
    iters = [i for i, s in enumerate(spans) if s.name == "ipm.iter"]
    kids = [[s.name for s in spans if s.parent == i] for i in iters]
    assert "ipm.capture" not in kids[0] and kids[1] == ["ipm.capture"] + turn
    assert all(k == turn for k in kids[2:])


@pytest.mark.gpu
def test_cuda_graph_mpc_period_matches_eager(cuda, monkeypatch):
    """One control period of ``mpc.run_fleet`` at B=1 (the initial plan
    and one warm re-solve, each a solve that captures once): every
    output equal bit for bit to the eager run's, the same launches."""
    from obca_torch import f32_solver_config, mpc

    specs, _, W0, _ = _graph_batch("parking", 1, cuda)
    cfg = f32_solver_config(max_iter=70)

    def period():
        return mpc.run_fleet(specs, cfg, 1, W0, resolve_mu=1e-4,
                             resolve_max_iter=60, resolve_tol=1e-3)

    eager, l_e, _, c_e = _counted(monkeypatch, False, period)
    graph, l_g, spans, c_g = _counted(monkeypatch, True, period)
    for name, t in _tensors(eager).items():
        assert torch.equal(t, _tensors(graph)[name]), name
    assert l_g == l_e and l_g["factor_se"] > 0
    solves = sum(s.name == "ipm.solve" for s in spans)
    assert solves == 2 and c_g["ipm.graph_captures"] == solves
    assert c_g["ipm.graph_replays"] == c_g["ipm.iters"] - solves


# Reserved over peak allocated device memory that graph-replayed solves
# may reach: the eager cache and the graphs' pool each hold up to about
# the peak, and with tensors of a gigabyte (B = 1024) the caching
# allocator's slack adds about as much again (3.51 on an H100).
RESERVED_OVER_PEAK = 4.0


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,passes", [((128,), 5),
                                          ((128, 1024, 128, 5), 2)],
                         ids=["b128", "mixed"])
def test_cuda_graph_memory_does_not_grow(sizes, passes, cuda):
    """Graph-replayed solves over the batch sizes ``sizes`` (5 is a
    rescue round's size) from an emptied cache: one pass to fill the
    caching allocator, then ``passes`` passes.  After the first of those
    no solve reserves more device memory than it left, because each
    solve's graphs are released and later captures reuse their pool,
    which keeps its highest level; and the reserved memory stays within
    RESERVED_OVER_PEAK times the peak allocated."""
    from obca_torch.solver import ipm

    batches = {B: _graph_batch("parking", B, cuda) for B in sizes}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    for B in sizes:
        ipm.solve_batch(*batches[B][:3], prob=batches[B][3])
    reserved = []
    for _ in range(passes):
        for B in sizes:
            specs, cfg, W0, prob = batches[B]
            ipm.solve_batch(specs, cfg, W0, prob=prob)
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(cuda))
    peak = torch.cuda.max_memory_allocated(cuda)
    n = len(sizes)
    assert max(reserved[n:]) <= reserved[n - 1], reserved
    assert max(reserved) <= RESERVED_OVER_PEAK * peak, (reserved, peak)
