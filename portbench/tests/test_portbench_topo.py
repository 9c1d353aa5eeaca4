"""What the cluttered-lot cell adds to the benchmark, by hand: the reader
of ``factor_se.busy_pct.sweep`` on a hand-made trace, and the mix's
draws of heading offsets."""

import numpy as np
import pytest

from portbench import harness, traffic, yardstick

FACTOR = "void factor_se_kernel<32>(float const*, float const*)"


def test_factor_busy_reader_by_hand():
    ms = 1_000_000
    # Window [0, 10 ms): two factor calls of 2 ms, an elementwise kernel
    # of 3 ms that overlaps the second by 1 ms, idle elsewhere; busy is
    # the union, 2 + 4 = 6 ms, of which the factor kernels take 4.
    events = [(FACTOR, 1 * ms, 3 * ms),
              ("elementwise_kernel", 5 * ms, 8 * ms),
              (FACTOR, 7 * ms, 9 * ms)]
    trace = yardstick.reduce_trace(events, 0, 10 * ms, [])
    assert trace["busy_s"] == pytest.approx(6e-3)
    read = harness.reader("factor_se.busy_pct.sweep")
    run = harness.Run(kind="sweep", trace=trace)
    assert read(run) == pytest.approx(100.0 * 4 / 6)
    assert read(harness.Run(kind="sweep", trace=None)) is None
    other = yardstick.reduce_trace(events[1:2], 0, 10 * ms, [])
    assert read(harness.Run(kind="sweep", trace=other)) is None


def test_mix_draws_heading_offsets():
    _, cfg, mix, _ = harness.cell(harness.benchmark(),
                                  "reverse_topo_sweep_b128")
    x0 = np.asarray(cfg["x0"])
    poses = traffic.start_poses(mix, x0, 2 ** 31 + 11, 1)
    d = poses - x0
    assert poses.shape == (128, 4)
    assert np.abs(d[:, :2]).max() <= 0.5
    assert np.abs(d[:, 2]).max() <= np.float32(0.15)
    assert np.abs(d[:, 2]).max() > 0.1 and (d[:, 3] == 0).all()
