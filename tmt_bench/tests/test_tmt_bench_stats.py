"""The benchmark's arithmetic: the rate over the whole window, the p99 over
every step, busy time as an interval union, K1's bytes."""

from __future__ import annotations

import statistics

import pytest

from tmt_bench import manifest, stats, trace
from tmt_bench.peaks import peak


def test_rate_is_over_the_whole_window():
    run = {"window": {"batch": 16384, "steps": 1000, "wall_s": 32.5,
                      "step_ms": [25.0] * 966 + [240.0] * 34}}
    assert manifest.reader("board_steps_per_s")(run) == 16384 * 1000 / 32.5


def test_p99_is_over_every_step():
    # one step in 30 is an auto-reset step: the p99 lies among them
    steps = [25.0 + i * 1e-3 for i in range(1000)]
    for i in range(0, 1000, 30):
        steps[i] = 240.0 + i * 1e-3
    run = {"window": {"step_ms": steps}}
    p99 = manifest.reader("step_ms_p99")(run)
    assert 240.0 < p99 < 241.0
    assert p99 == pytest.approx(stats.percentile(steps, 99))


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 99) == pytest.approx(99.01)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 99) == 3.0


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(5, 6), (0, 10)], 10.0),
    ([(0, 1), (1, 2)], 2.0),
])
def test_busy_is_an_interval_union(intervals, length):
    assert stats.union_length(intervals) == length


def test_idle_gaps_and_their_labels():
    prof = {"ops": [("k", 10.0, 20.0), ("k", 15.0, 30.0), ("k", 50.0, 60.0)],
            "spans": [("draw", 0, 0.0, 40.0), ("step", 0, 40.0, 70.0), ("draw", 1, 70.0, 80.0),
                      ("step", 1, 80.0, 100.0)],
            "step_done": [False, True], "steps": 2, "wall_s": 1e-4}
    assert stats.idle_gaps([(s, e) for _, s, e in prof["ops"]], 0.0, 100.0) == [
        (0.0, 10.0), (30.0, 50.0), (60.0, 100.0)]
    got = trace.gaps(prof)
    assert got[0] == ("autoreset_step", 40e-6)  # 60-100 us: its middle, 80, opens step 1
    assert got[1:] == [("env_step", 20e-6), ("draw", 10e-6)]
    assert trace.busy_s(prof) == pytest.approx(30e-6)
    prof["spans"][2] = ("draw", 1, 70.0, 81.0)
    assert trace.gaps(prof)[0] == ("draw", 40e-6)


def test_k1_bytes_give_the_bound_of_the_kernel_table():
    """10x10, 4 colours, B=16,384: 0.0049 ms at 3.35 TB/s."""
    k1 = __import__("importlib").import_module("tmt_bench.metrics.k1_roofline")
    b = k1.k1_bytes(16384, 10, 10, 180)
    assert b == 16384 * (400 + 16 + 400 + 4 + 4 + 1 + 180)
    bw = peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s")
    assert round(1e3 * b / bw, 4) == 0.0049


def test_k1_roofline_reads_k1s_device_time_only():
    read = manifest.reader("k1_roofline")
    cfg = {"num_rows": 10, "num_cols": 10}
    ops = [("void cascade_kernel<10, 10>(int)", 0.0, 10.0), ("void cascade_sp_kernel<10,10>()", 0.0, 500.0),
           ("void cascade_kernel<10, 10>(int)", 20.0, 30.0)]
    run = {"profile": {"ops": ops}, "device_kind": "NVIDIA H100 80GB HBM3",
           "config": cfg, "traffic": {"batch": 16384}}
    bound_us = 2 * 16384 * 1005 / 3.35e12 * 1e6
    assert read(run) == pytest.approx(100 * bound_us / 20.0)
    assert read(dict(run, device_kind="some other card")) is None
    assert read(dict(run, profile={"ops": ops[1:2]})) is None


def test_port_kernel_readers_take_the_names_from_the_benchmarks_own_list():
    """K1-K5 by ``metrics/port_kernels.json``: a listed kernel that no longer
    shows lowers ``port_kernels_seen``, and its time moves to the plain ops."""
    assert trace.port_kernels() == ("cascade_kernel", "cascade_sp_kernel", "mask_sp_kernel",
                                    "specials_trip_kernel", "combination_trip_kernel")
    ops = [("void (anonymous namespace)::cascade_sp_kernel<tmt::Lines<10, 10>>()", 0.0, 300.0),
           ("void mask_sp_kernel<10, 10>()", 300.0, 400.0),
           ("void at::native::vectorized_elementwise_kernel<2>()", 400.0, 1000.0),
           ("Memcpy DtoD (Device -> Device)", 1000.0, 1100.0)]
    run = {"profile": {"ops": ops, "steps": 2}}
    seen, port_ms, plain_ms = (manifest.reader(n) for n in (
        "port_kernels_seen", "port_kernels_device_ms", "plain_ops_device_ms"))
    assert seen(run) == 2
    assert port_ms(run) == pytest.approx(400e-3 / 2)
    assert plain_ms(run) == pytest.approx(600e-3 / 2)
    renamed = dict(run, profile={"ops": [("void mask_kernel_v2<10, 10>()", 300.0, 400.0)
                                         if "mask_sp" in o[0] else o for o in ops], "steps": 2})
    assert seen(renamed) == 1
    assert port_ms(renamed) == pytest.approx(300e-3 / 2)
    assert plain_ms(renamed) == pytest.approx(700e-3 / 2)
    for read in (seen, port_ms, plain_ms):
        assert read({"profile": None}) is None
