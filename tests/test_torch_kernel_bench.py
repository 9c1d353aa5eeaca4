"""obca_torch's kernel bench and its probe kernels against the JAX
kernel bench (``tools/kernel_bench.py``) on the same inputs.

* ``probes.stream_add_one_plain`` against the Pallas ``_pstream_kernel``
  in interpret mode, and ``probes.fma_probe_plain`` against the jitted
  ``fma_chain`` expression;
* ``obca_torch.tools.kernel_bench`` run end to end on the CPU, its
  models against ``kernel_costs``, and its synthetic system against the
  JAX tool's, value for value.

Both JAX functions are closures inside that tool's ``main()`` and
cannot be imported, so each test restates their lines.  The probe
kernels themselves are held against their plain versions on the card in
``tests/test_torch_cuda.py``.  Inputs are made with numpy from a seed.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from obca_torch.solver.kernels import probes
from obca_torch.tools import kernel_bench as kb
from obca_tpu import nlp as jnlp
from obca_tpu.solver.pallas import blocktri_kernel as jbk
from obca_tpu.spec import reverse_parking_spec as j_reverse_parking_spec

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)

# The JAX tool's stream array is [S, nzp, nzp, Bp]; a small one here.
SHAPE = (3, 8, 8, 128)


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


def test_stream_add_one_plain_matches_pallas_stream(x_np):
    """x + 1 exactly, as the Pallas stream kernel computes it with the
    tool's BlockSpecs (one [1, nzp, nzp, Bp] block per grid step, in
    VMEM), run in interpret mode."""
    S, nzp, _, Bp = SHAPE

    def _pstream_kernel(x_ref, o_ref):  # tools/kernel_bench.py:231-232
        o_ref[0] = x_ref[0] + 1.0

    blk4 = (1, nzp, nzp, Bp)
    pstream_one = pl.pallas_call(
        _pstream_kernel, grid=(S,), name="pallas_stream",
        in_specs=[pl.BlockSpec(blk4, lambda k: (k, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(blk4, lambda k: (k, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(SHAPE, jnp.float32),
        interpret=True)
    want = np.asarray(pstream_one(jnp.asarray(x_np)))
    got = probes.stream_add_one_plain(torch.from_numpy(x_np))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # On a CPU tensor the wrapper is its plain version.
    np.testing.assert_array_equal(
        probes.stream_add_one(torch.from_numpy(x_np)).numpy(), want)


def test_fma_probe_plain_matches_fma_chain(x_np):
    """The FMA probe's plain version against the JAX tool's fma_chain,
    jitted on the CPU, float32 on both sides: rtol 1e-6.  On this input
    the two lie at most 4 units in the last place apart (3.1e-7
    relative); rounding each product and sum apart, as eager float32 ops
    do, would lie 18 units away."""
    a_ = jnp.float32(1.0000001)
    b_ = jnp.float32(1e-7)

    @jax.jit
    def fma_chain(x):  # tools/kernel_bench.py:263-271
        ys = [x * jnp.float32(1.0 + 1e-6 * i) for i in range(16)]
        for _ in range(16):
            ys = [y * a_ + b_ for y in ys]
        out = ys[0]
        for y in ys[1:]:
            out = out + y
        return out

    want = np.asarray(fma_chain(jnp.asarray(x_np)))
    got = probes.fma_probe_plain(torch.from_numpy(x_np))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        probes.fma_probe(torch.from_numpy(x_np)).numpy(), got.numpy())
    # 256 FMAs of two operations, 16 scaling multiplies, 15 adds.
    assert probes.FMA_PROBE_OPS == 2 * 16 * 16 + 16 + 15


def _no_fmas(x):
    return sum(x * torch.tensor(1.0 + 1e-6 * i, dtype=torch.float32)
               for i in range(16))


def _unfused(x):
    a = torch.tensor(1.0000001, dtype=torch.float32)
    b = torch.tensor(1e-7, dtype=torch.float32)
    ys = [x * torch.tensor(1.0 + 1e-6 * i, dtype=torch.float32)
          for i in range(16)]
    for _ in range(16):
        ys = [y * a + b for y in ys]
    out = ys[0]
    for y in ys[1:]:
        out = out + y
    return out


@pytest.mark.parametrize("wrong", [_no_fmas, lambda x: 16 * x, _unfused],
                         ids=["no_fmas", "times_16", "unfused"])
def test_fma_probe_check_rejects_wrong_kernels(x_np, wrong):
    """The card's check of the FMA probe (every element within 2 units in
    the last place of the plain version) rejects what a wrong kernel
    would give: the FMA loop left out, 16 x, or each multiply-add
    rounded twice."""
    x = torch.from_numpy(x_np)
    plain = probes.fma_probe_plain(x)
    assert probes.max_ulps(plain, plain) == 0
    assert probes.max_ulps(wrong(x), plain) > 2


def test_kernel_bench_runs_on_cpu():
    """main() at B=2, N=8 on the CPU prints one JSON line with the JAX
    tool's keys (and the port's), its models equal kernel_costs at those
    shapes, and it reports no time from a CPU run."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = kb.main(B=2, N=8, n_chain=2, device="cpu")
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    keys = {"B", "N", "n_chain", "hbm_spec_gbps", "device",
            "torch_stream_gbps", "cuda_stream_gbps", "fma_probe_tflops"}
    for p in ("factor", "solve"):
        keys |= {f"{p}_{k}" for k in (
            "ms", "trace_ms", "model_bytes_MB", "sol_ms", "pct_of_sol",
            "model_gflop", "achieved_tflops", "pct_of_measured")}
    assert keys <= set(out)
    assert (out["B"], out["N"], out["n_chain"]) == (2, 8, 2)
    assert out["hbm_spec_gbps"] == 3350 and out["device"] == "cpu"
    costs = kb.kernel_costs(2, out["S"], out["nz"], out["nnz"], out["C"])
    assert out["S"] == 9 and out["nz"] == 56 and out["nnz"] == 11
    assert out["factor_model_bytes_MB"] == costs["factor_se"][0] / 1e6
    assert out["factor_model_gflop"] == costs["factor_se"][1] / 1e9
    assert out["solve_model_bytes_MB"] == (
        costs["fwd_se"][0] + costs["bwd_se"][0]) / 1e6
    assert out["solve_model_gflop"] == (
        costs["fwd_se"][1] + costs["bwd_se"][1]) / 1e9
    assert out["factor_sol_ms"] == kb.bound_ms(*costs["factor_se"])[0]
    for k in ("factor_ms", "factor_trace_ms", "solve_pct_of_sol",
              "torch_stream_gbps", "cuda_stream_gbps", "fma_probe_tflops"):
        assert out[k] is None


def test_kernel_costs_probes_and_bounds():
    """The probes' models at the bench's main shape: 260.1 MB read and
    written (0.0776 ms at 3.35 TB/s, bytes-bound) for the stream kernel,
    17.66 GFLOP (0.2635 ms at 67 TFLOP/s, operations-bound) for the FMA
    probe."""
    costs = kb.kernel_costs(128, 81, 56, 11, 11)
    n = 128 * 81 * 56 * 56
    assert costs["stream_add_one"] == (8 * n, n)
    assert costs["fma_probe"] == (8 * n, 543 * n)
    t, by = kb.bound_ms(*costs["stream_add_one"])
    assert by == "bytes" and abs(t - 0.0776) < 1e-4
    t, by = kb.bound_ms(*costs["fma_probe"])
    assert by == "operations" and abs(t - 0.2635) < 1e-4


def test_synthetic_system_matches_jax_tool():
    """The bench's synthetic system is the JAX tool's, value for value,
    at B=2, N=8 (tools/kernel_bench.py:129-152, restated)."""
    B, N = 2, 8
    spec = j_reverse_parking_spec(N=N, Ts=24.0 / N, dtype=jnp.float32)
    L = jnlp.layout_of(spec)
    rows, cols = jnlp.coupling_structure(L)
    rows = [int(r) for r in rows]
    cols = [int(c) for c in cols]
    S = N + 1
    nzp = -(-L.nz // 8) * 8
    Bp = -(-B // jbk.LANES) * jbk.LANES
    rng = np.random.default_rng(0)
    K = np.zeros((S, nzp, nzp, Bp), np.float32)
    R = rng.standard_normal((S, L.nw, L.nw)).astype(np.float32)
    A = (R @ np.swapaxes(R, -1, -2) / L.nw
         + 2.0 * np.eye(L.nw, dtype=np.float32))
    K[:, : L.nw, : L.nw, :] = A[..., None]
    idx = np.arange(L.nw, nzp)
    K[:, idx, idx, :] = -1.0
    ev = 0.3 * rng.standard_normal((S - 1, len(rows), Bp)).astype(
        np.float32)
    reg = np.zeros((nzp, Bp), np.float32)
    r = rng.standard_normal((S, nzp, Bp)).astype(np.float32)

    Kt, evt, regt, rt, pat = kb.synthetic_system(B, N, "cpu")
    nz = L.nz
    np.testing.assert_array_equal(pat.rows, rows)
    np.testing.assert_array_equal(pat.cols, cols)
    for got, want in (
            (Kt, np.moveaxis(K[:, :nz, :nz, :B], -1, 0)),
            (evt, np.moveaxis(ev[..., :B], -1, 0)),
            (regt, reg[:nz, :B].T),
            (rt, np.moveaxis(r[:, :nz, :B], -1, 0))):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
