"""Metric arithmetic over synthetic samples and a synthetic device trace."""
import types

import numpy as np
import pytest

from perfbench import devtrace, peaks, stats
from perfbench.spec import reader


def _run(events, trace=None, before=None, after=None, num_edges=1000, traces=None):
    """A run's facts as the harness gives the readers: ``traces`` is every
    rank's device trace, rank 0's (``trace``) alone on one card."""
    if traces is None and trace is not None:
        traces = [trace]
    return types.SimpleNamespace(events=events, trace=trace, traces=traces, setup_s=12.5, num_edges=num_edges,
                                 counters_before=before or {}, counters_after=after or {})


def _rescales(ms, k0=4):
    out, t, k = [], 0.0, k0
    for i, m in enumerate(ms):
        k_new = 5 + (i * 37) % 120  # in [5, 124], never the k before it
        out.append({"kind": "rescale", "ok": True, "due": t, "start": t, "end": t + m / 1e3, "k_old": k,
                    "k_new": k_new, "migrate_s": m / 4e3, "recheck_s": m / 2e3})
        t, k = t + m / 1e3, k_new
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


def _one_card_bytes(n, k):
    """Both kernels' bytes on one card at k, written out: the migration reads
    8 B of every edge and writes 12 B a slot of k rows of ⌈n/k⌉; the count
    reads k rows of 2·⌈n/k⌉ int32 ids and writes a count a row."""
    width = -(-n // k)
    return 8 * n + 12 * k * width, k * 2 * width * 4 + k * 4


def test_byte_formulas_at_the_smokes_rmat20_shapes():
    n = 15_701_711  # RMAT-20 after deduplication: a plan moves 314.0 MB, a k = 16 re-check reads 125.6 MB
    for k_old, k in ((16, 17), (8, 12), (12, 8)):
        assert peaks.rescale_migrate_rank_bytes(n, k_old, k, 1, 0) == 8 * n + 12 * k * -(-n // k)
    assert round(peaks.rescale_migrate_rank_bytes(n, 16, 17, 1, 0) / 1e6, 1) == 314.0
    assert peaks.rescale_migrate_rank_bytes(n, 16, 17, 1, 0) == 314_034_412
    assert peaks.segment_rf_rank_bytes(n, 16, 1) == 16 * 1_962_714 * 4 + 16 * 4 == 125_613_760
    assert peaks.segment_rf_rank_bytes(n, 16, 1) / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0375, abs=5e-5)
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
    bytes_moved = _one_card_bytes(1000, events[0]["k_new"])[0]
    got = reader("rescale_migrate_roofline")(_run(events, trace=t))
    assert got == pytest.approx(100 * bytes_moved / peaks.HBM_BYTES_PER_S / 100e-6)
    assert reader("segment_rf_roofline")(_run(events + _rescales([5.0]), trace=t)) is None


# ------------------------------------------------------------ rooflines over ranks
def _brute_rank_bytes(n, k_old, k_new, g, r):
    """Both kernels' bytes on rank r, from explicit chunk ranges: every
    ordered id placed in its old and new chunk by a walk over the ranges."""
    def owner(k):
        at, out = 0, [None] * n
        for p in range(k):
            size = n // k + (1 if p >= k - n % k else 0)
            for i in range(at, at + size):
                out[i] = p
            at += size
        assert at == n
        return out

    old, new = owner(k_old), owner(k_new)
    copied = sum(1 for i in range(n) if new[i] % g == r and old[i] % g == r)
    received = sum(1 for i in range(n) if new[i] % g == r and old[i] % g != r)
    rows = len(range(r, -(-k_new // g) * g, g))  # the rank's rows, padding rows past k_new included
    width = max(new.count(p) for p in range(k_new))
    return 8 * copied + 12 * rows * width - 8 * received, rows * (2 * width) * 4 + rows * 4


@pytest.mark.parametrize("n, k_old, k_new", [(1000, 4, 7), (1000, 128, 5), (15_701_711, 17, 12), (997, 33, 34)])
def test_rank_byte_counts_at_one_rank_are_the_one_card_counts(n, k_old, k_new):
    migrate, count = _one_card_bytes(n, k_new)
    assert peaks.rescale_migrate_rank_bytes(n, k_old, k_new, 1, 0) == migrate
    assert peaks.segment_rf_rank_bytes(n, k_new, 1) == count


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("n, k_old, k_new", [(1000, 5, 7), (1000, 7, 5), (997, 13, 127), (1001, 126, 9), (50, 3, 6)])
def test_rank_byte_counts_match_a_count_over_explicit_chunk_ranges(g, n, k_old, k_new):
    for r in range(g):
        migrate, count = _brute_rank_bytes(n, k_old, k_new, g, r)
        assert peaks.rescale_migrate_rank_bytes(n, k_old, k_new, g, r) == migrate, r
        assert peaks.segment_rf_rank_bytes(n, k_new, g) == count, r
    # Over the ranks the migration reads and writes what one card's does, less
    # the received edges, which the exchange writes, plus the padding rows.
    whole = sum(_brute_rank_bytes(n, k_old, k_new, g, r)[0] for r in range(g))
    assert whole <= _one_card_bytes(n, k_new)[0] + 12 * (g - 1) * -(-n // k_new)


def _rank_trace(migrate_us, count_us, launches=1):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window", "ts": 0, "dur": 10_000, "pid": 1,
           "tid": 1}]
    for i in range(launches):
        ev.append({"ph": "X", "cat": "kernel", "name": "rescale_migrate_kernel(uint2 const*)", "ts": 10 + 100 * i,
                   "dur": migrate_us, "pid": 0, "tid": 7})
        ev.append({"ph": "X", "cat": "kernel", "name": "segment_rf_kernel(int const*)", "ts": 5000 + 100 * i,
                   "dur": count_us, "pid": 0, "tid": 7})
    return devtrace.DeviceTrace(ev)


@pytest.mark.parametrize("events", [1, 3])
def test_roofline_readers_over_one_trace_give_the_one_card_value(events):
    done = _rescales([5.0] * events)
    trace = _rank_trace(40.0, 20.0, launches=events)
    run = _run(done, trace=trace, num_edges=123_457)
    # The one-card readers' arithmetic: the one-card bytes over rank 0's kernel time.
    migrate = sum(_one_card_bytes(123_457, e["k_new"])[0] for e in done)
    count = sum(_one_card_bytes(123_457, e["k_new"])[1] for e in done)
    assert reader("rescale_migrate_roofline")(run) == peaks.roofline_pct(migrate, trace.kernel("rescale_migrate")[1])
    assert reader("segment_rf_roofline")(run) == peaks.roofline_pct(count, trace.kernel("segment_rf")[1])


def test_roofline_readers_pool_the_ranks_and_need_every_ranks_launches():
    n, g = 1_000_003, 4
    done = _rescales([5.0, 6.0, 7.0], k0=9)
    # Each rank's kernels take their own bytes at 80% and 50% of the peak rate,
    # in a per-rank time of their own: the pooled share lies between.
    migrate = [sum(peaks.rescale_migrate_rank_bytes(n, e["k_old"], e["k_new"], g, r) for e in done) for r in range(g)]
    count = [sum(peaks.segment_rf_rank_bytes(n, e["k_new"], g) for e in done) for _ in range(g)]
    rates = (0.8, 0.5, 0.9, 0.6)

    def seconds(moved):  # each rank's kernel time at its rate
        return [b / peaks.HBM_BYTES_PER_S / rate for b, rate in zip(moved, rates)]

    def want(moved):
        return 100 * sum(moved) / peaks.HBM_BYTES_PER_S / sum(seconds(moved))

    traces = [_rank_trace(1e6 * a / len(done), 1e6 * b / len(done), launches=len(done))
              for a, b in zip(seconds(migrate), seconds(count))]
    run = _run(done, trace=traces[0], traces=traces, num_edges=n)
    got_migrate, got_count = reader("rescale_migrate_roofline")(run), reader("segment_rf_roofline")(run)
    assert got_migrate == pytest.approx(want(migrate), rel=1e-9) and 50 < got_migrate < 90
    assert got_count == pytest.approx(want(count), rel=1e-9) and 50 < got_count < 90
    # Rank 0's bytes alone over its time would read the one-card count against a quarter of the work.
    assert got_migrate < peaks.roofline_pct(sum(_one_card_bytes(n, e["k_new"])[0] for e in done),
                                            traces[0].kernel("rescale_migrate_kernel")[1])
    short = traces[:2] + [_rank_trace(10.0, 10.0, launches=len(done) - 1)] + traces[3:]
    for name in ("rescale_migrate_roofline", "segment_rf_roofline"):
        assert reader(name)(_run(done, trace=short[0], traces=short, num_edges=n)) is None, name
