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

from obca_torch.solver.kernels import blocktri_se as bk

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
    for name in bk.launches:
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
