"""The frozen yardsticks: kernel costs against the port's kernel bench
at the main path's shapes, the traffic generator as a pure function of
the seed, and the metric arithmetic on a hand-made trace."""

import numpy as np
import pytest

from portbench import harness, traffic, yardstick


@pytest.mark.parametrize("shape", [
    (128, 81, 56, 11, 11), (1024, 81, 56, 11, 11), (1, 81, 56, 11, 11),
    (128, 61, 44, 11, 11), (128, 81, 72, 11, 11)])
def test_frozen_costs_equal_the_kernel_bench(shape):
    from obca_torch.tools import kernel_bench

    ours = yardstick.kernel_costs(*shape)
    theirs = kernel_bench.kernel_costs(*shape)
    for name, cost in ours.items():
        assert cost == theirs[name], name
        assert yardstick.bound_s(*cost) * 1e3 == pytest.approx(
            kernel_bench.bound_ms(*cost)[0], rel=1e-12)
    assert (yardstick.PEAK_BYTES_PER_S, yardstick.PEAK_F32_FLOPS) == (
        kernel_bench.PEAK_BYTES_PER_S, kernel_bench.PEAK_F32_FLOPS)


MIX = {"lanes": 128, "shift": [0.5, 0.5], "shift_dtype": "float32"}
X0 = [-6.0, 9.0, 0.0, 0.0]


def test_traffic_is_a_function_of_seed_and_index():
    big = 2 ** 31 + 12345
    a = traffic.start_poses(MIX, X0, big, 3)
    assert np.array_equal(a, traffic.start_poses(MIX, X0, big, 3))
    # Whatever ran before: request 3 alone equals request 3 after 1, 2.
    for i in (1, 2):
        traffic.start_poses(MIX, X0, big, i)
    assert np.array_equal(a, traffic.start_poses(MIX, X0, big, 3))
    assert not np.array_equal(a, traffic.start_poses(MIX, X0, big, 4))
    assert not np.array_equal(a, traffic.start_poses(MIX, X0, big + 1, 3))
    assert a.shape == (128, 4)
    assert np.all(np.abs(a[:, :2] - np.asarray(X0[:2])) <= 0.5)
    assert np.array_equal(a[:, 2:], np.zeros((128, 2)))
    # float32 draws, as the program is given them.
    d = a[:, :2] - np.asarray(X0[:2])
    assert np.array_equal(d, d.astype(np.float32).astype(np.float64))


def test_reduce_trace_by_hand():
    ms = 1_000_000
    spans = [("warmstart", 0, 10 * ms), ("solve", 10 * ms, 100 * ms)]
    events = [("factor_se_kernel<56>", 12 * ms, 14 * ms),
              ("fwd_se_kernel", 14 * ms, 15 * ms),
              ("elementwise", 14 * ms + ms // 2, 16 * ms),   # overlaps
              ("factor_se_kernel<56>", 50 * ms, 52 * ms),
              ("outside", 200 * ms, 201 * ms)]
    t = yardstick.reduce_trace(events, 0, 100 * ms, spans)
    # busy: [12, 16] and [50, 52] = 6 ms of a 100 ms window.
    assert t["busy_s"] == pytest.approx(6e-3)
    assert t["window_s"] == pytest.approx(0.1)
    assert t["by_name"]["factor_se_kernel<56>"] == pytest.approx(4e-3)
    assert t["device_ops"][0] == ["factor_se_kernel<56>", pytest.approx(4e-3)]
    # gaps: [52, 100] in solve, [16, 50] in solve, [0, 12] begun in
    # warmstart: the totals by span first, then the longest gaps.
    assert t["idle_gaps"] == [["solve: all", pytest.approx(0.082)],
                              ["warmstart: all", pytest.approx(0.012)],
                              ["solve", pytest.approx(0.048)],
                              ["solve", pytest.approx(0.034)],
                              ["warmstart", pytest.approx(0.012)]]

    run = harness.Run(kind="sweep", window_s=0.1, trace=t,
                      seconds={"warmstart": 0.01, "solve": 0.09},
                      launches={"factor_se": 2},
                      factor_calls=[(128, 81, 56, 11, 11)] * 2,
                      requests=[{"lanes": 128, "converged": 127,
                                 "iters": np.full(128, 30)}])
    read = lambda name: harness.reader(name)(run)  # noqa: E731
    assert read("device.idle_pct.sweep") == pytest.approx(94.0)
    assert read("ipm.ms_per_iter.sweep") == pytest.approx(45.0)
    assert read("warmstart.share_pct.sweep") == pytest.approx(10.0)
    assert read("ipm.iters_per_lane.sweep") == pytest.approx(30.0)
    assert read("converged_solves_per_s") == pytest.approx(1270.0)
    bound = yardstick.bound_s(*yardstick.kernel_costs(128, 81, 56, 11, 11)[
        "factor_se"])
    assert read("factor_se.roofline_pct.sweep") == pytest.approx(
        100 * 2 * bound / 4e-3)
    assert read("ms_per_period") is None


def test_mpc_readers_by_hand():
    it = np.array([[60, 9, 6, 60, 5]])
    run = harness.Run(kind="mpc", window_s=2.5, mix={"resolve_max_iter": 60},
                      launches={"factor_se": 250}, trace=None,
                      periods=[{"iters": it, "status": np.zeros_like(it)}])
    read = lambda name: harness.reader(name)(run)  # noqa: E731
    assert read("ms_per_period") == pytest.approx(500.0)
    assert read("mpc.iters_per_period") == pytest.approx(28.0)
    assert read("mpc.cap_share_pct") == pytest.approx(40.0)
    assert read("ipm.ms_per_iter.mpc") == pytest.approx(10.0)
    assert read("device.idle_pct.mpc") is None
    assert read("converged_solves_per_s") is None


def test_pool_orders_one_set_of_requests():
    mix = dict(MIX, lanes=1, pool=6, pool_seed=0)
    one = [traffic.start_poses(mix, X0, 2 ** 31 + 5, i) for i in range(1, 7)]
    two = [traffic.start_poses(mix, X0, 17, i) for i in range(1, 7)]
    key = lambda a: tuple(a.ravel())  # noqa: E731
    assert sorted(map(key, one)) == sorted(map(key, two))
    assert [key(a) for a in one] != [key(a) for a in two]
    # The cycle repeats; the warm-up is the seed's own draw.
    assert key(traffic.start_poses(mix, X0, 17, 7)) == key(two[0])
    assert key(traffic.start_poses(mix, X0, 17, 0)) not in map(key, two)
