"""Metric arithmetic over synthetic samples and a synthetic device trace."""
import types

import numpy as np
import pytest

from perfbench import devtrace, peaks, stats
from perfbench.spec import reader


def _run(events, trace=None, before=None, after=None, num_edges=1000):
    return types.SimpleNamespace(events=events, trace=trace, setup_s=12.5, num_edges=num_edges,
                                 counters_before=before or {}, counters_after=after or {})


def _rescales(ms):
    out, t = [], 0.0
    for i, m in enumerate(ms):
        out.append({"kind": "rescale", "ok": True, "due": t, "start": t, "end": t + m / 1e3, "k_new": 4 + i % 100,
                    "migrate_s": m / 4e3, "recheck_s": m / 2e3})
        t += m / 1e3
    return out


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear_default(q):
    xs = np.random.default_rng(3).lognormal(size=357)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)


def test_a_tail_is_taken_over_the_whole_window_not_from_pieces():
    # Ten calm pieces and one slow one: the median of the pieces' 95th
    # percentiles hides the slow piece, the window's own 95th does not.
    ms = [10.0] * 1000 + [100.0] * 100
    whole = reader("rescale_ms_p95")(_run(_rescales(ms)))
    pieces = np.median([np.percentile(ms[i:i + 100], 95) for i in range(0, 1100, 100)])
    assert whole == pytest.approx(np.percentile(ms, 95)) and whole > 5 * pieces


def test_latency_readers_time_queries_from_due_and_skip_failures():
    events = [
        {"kind": "pagerank", "ok": True, "due": 1.0, "start": 1.2, "end": 1.3},
        {"kind": "sssp", "ok": True, "due": 2.0, "start": 2.0, "end": 2.05},
        {"kind": "wcc", "ok": False, "due": 3.0, "start": 3.0, "end": 9.0},
        {"kind": "rescale", "ok": True, "due": 4.0, "start": 4.0, "end": 4.01, "migrate_s": 1e-3, "recheck_s": 5e-3},
    ]
    run = _run(events)
    assert reader("query_ms_p50")(run) == pytest.approx(175.0)
    assert reader("query_ms_p95")(run) == pytest.approx(50 + 0.95 * 250)
    assert reader("engine.service_ms_mean")(run) == pytest.approx(75.0)
    assert reader("rescale_ms_p50")(run) == pytest.approx(10.0)
    assert reader("rescale.migrate_ms")(run) == pytest.approx(1.0)
    assert reader("rescale.recheck_ms")(run) == pytest.approx(5.0)
    assert reader("setup_s")(run) == 12.5


def test_readers_give_nothing_where_nothing_is_to_read():
    run = _run([])
    for name in ("rescale_ms_p50", "rescale_ms_p95", "query_ms_p50", "query_ms_p95", "rescale.migrate_ms",
                 "rescale.recheck_ms", "rescale.program_miss_pct", "engine.service_ms_mean",
                 "rescale_migrate_roofline", "segment_rf_roofline", "device_idle_pct.rescale",
                 "device_idle_pct.query"):
        assert reader(name)(run) is None, name


def test_program_miss_share_counts_the_window_only():
    run = _run([], before={"hits": 5, "misses": 3}, after={"hits": 35, "misses": 13})
    assert reader("rescale.program_miss_pct")(run) == pytest.approx(25.0)


def test_byte_formulas_at_the_smokes_rmat20_shapes():
    n = 15_701_711  # RMAT-20 after deduplication: a plan moves 314.0 MB, a k = 16 re-check reads 125.6 MB
    for k in (17, 12, 8):
        assert peaks.rescale_migrate_bytes(n, k) == 8 * n + 12 * k * -(-n // k)
    assert round(peaks.rescale_migrate_bytes(n, 17) / 1e6, 1) == 314.0
    assert peaks.segment_rf_bytes(n, 16) == 16 * 1_962_714 * 4 + 16 * 4
    assert peaks.segment_rf_bytes(n, 16) / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0375, abs=5e-5)
    assert peaks.roofline_pct(3_350_000, 1e-6) == pytest.approx(100.0)
    assert peaks.roofline_pct(10, 0.0) is None


def _trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window", "ts": 0, "dur": 1000, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.rescale", "ts": 100, "dur": 500, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 150, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.wait", "ts": 700, "dur": 250, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "rescale_migrate_kernel(uint2 const*)", "ts": 200, "dur": 100, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "segment_rf_kernel(int const*)", "ts": 250, "dur": 100, "pid": 0, "tid": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400, "dur": 50, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "perfbench.window", "ts": 0, "dur": 1000, "pid": 0, "tid": 9},
        {"ph": "X", "cat": "kernel", "name": "before_the_window", "ts": -500, "dur": 100, "pid": 0, "tid": 7},
    ]
    return devtrace.DeviceTrace(ev)


def test_device_busy_is_the_union_of_intervals_in_the_window():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(200e-6)  # [200, 350) and [400, 450): overlapping kernels count once
    assert t.kernel("rescale_migrate_kernel") == (1, pytest.approx(100e-6))
    assert t.kernel("segment_rf_kernel") == (1, pytest.approx(100e-6))
    assert reader("device_idle_pct.rescale")(_run([], trace=t)) == pytest.approx(80.0)
    assert t.top_ops(2) == [["rescale_migrate_kernel(uint2 const*)", pytest.approx(1e-4)],
                            ["segment_rf_kernel(int const*)", pytest.approx(1e-4)]]


def test_idle_gaps_are_named_by_the_host_activity_open_at_them():
    idle = dict(_trace().idle_by_host(10))
    assert idle["perfbench.wait"] == pytest.approx(550e-6)  # [450, 1000), its midpoint in the wait
    assert idle["perfbench.rescale"] == pytest.approx(250e-6)  # [0, 200) and [350, 400), midpoints in the rescale
    assert sum(idle.values()) == pytest.approx(800e-6)


def test_roofline_readers_need_one_launch_per_event():
    t = _trace()
    events = _rescales([5.0])
    bytes_moved = peaks.rescale_migrate_bytes(1000, events[0]["k_new"])
    got = reader("rescale_migrate_roofline")(_run(events, trace=t))
    assert got == pytest.approx(100 * bytes_moved / peaks.HBM_BYTES_PER_S / 100e-6)
    assert reader("segment_rf_roofline")(_run(events + _rescales([5.0]), trace=t)) is None
