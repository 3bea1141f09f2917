"""The readers of the program's spans over a synthetic device trace: three
scale events (a cache miss, a hit, a hit with the re-check off) and one
SSSP query of three sweeps."""
import types

import pytest

from perfbench import devtrace, spans
from perfbench.spec import reader

SPAN_METRICS = ("rescale.plan_ms", "rescale.table_build_ms", "rescale.layout_check_ms", "rescale.sort_ms",
                "engine.sweep_ms")


def _run(trace):
    return types.SimpleNamespace(events=[], trace=trace, setup_s=1.0, num_edges=1000,
                                 counters_before={}, counters_after={})


def _host(name, a, b, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "pid": 1, "tid": tid}


def _dev(name, a, b, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "pid": 0, "tid": 7}


SORT = "void cub::DeviceRadixSortOnesweepKernel<int>"
SEGMENT_RF = "segment_rf_kernel(int const*, int*)"


def _window(program_spans: bool = True):
    ev = [_host("perfbench.window", 0, 10_000), _host("rescale.plan", -900, -100)]  # the last before the window
    ev += [_host("perfbench.rescale", 100, 3000), _host("perfbench.rescale", 4000, 6000),
           _host("perfbench.rescale", 6100, 6500), _host("perfbench.sssp", 7000, 9000)]
    if program_spans:
        ev += [  # a miss: the table is built
            _host("rescale.plan", 110, 310), _host("rescale.execute", 320, 2900),
            _host("rescale.layout_check", 330, 530), _host("rescale.table_build", 540, 1140),
            _host("rescale.migrate", 1150, 1450), _host("rescale.recheck", 1460, 2890),
            _host("rescale.recheck.rows", 1465, 1500), _host("rescale.recheck.count", 1505, 2880),
        ]
        ev += [  # a hit
            _host("rescale.plan", 4010, 4410), _host("rescale.execute", 4420, 5900),
            _host("rescale.layout_check", 4430, 4530), _host("rescale.migrate", 4540, 4700),
            _host("rescale.recheck", 4710, 5890),
        ]
        ev += [  # a hit with the re-check off: no segment_rf launch
            _host("rescale.plan", 6110, 6210), _host("rescale.execute", 6220, 6490),
            _host("rescale.layout_check", 6230, 6330), _host("rescale.migrate", 6340, 6390),
            _host("rescale.recheck", 6400, 6480),
        ]
        ev += [_host("query.sssp", 7010, 8990), _host("query.sweep", 7020, 7520),
               _host("query.sweep", 7530, 8330), _host("query.sweep", 8340, 8940)]
        ev += [_host("query.sweep", 7020, 9020, tid=2)]  # another thread's range is not the program's
    ev += [
        _dev("rescale_migrate_kernel(uint2 const*)", 1200, 1400),
        _dev(SORT, 1470, 1900), _dev(SORT, 1950, 2300), _dev(SEGMENT_RF, 2400, 2500),
        _dev("Memcpy DtoH", 2510, 2520, cat="gpu_memcpy"),
        _dev("rescale_migrate_kernel(uint2 const*)", 4600, 4650),
        _dev(SORT, 4720, 5000), _dev(SORT, 4900, 5120), _dev(SEGMENT_RF, 5200, 5300),
        _dev("rescale_migrate_kernel(uint2 const*)", 6350, 6380),
        _dev("scatter_gather_elementwise_kernel", 7100, 7500),
    ]
    return devtrace.DeviceTrace(ev)


def test_each_reader_reads_its_spans():
    run = _run(_window())
    assert reader("rescale.plan_ms")(run) == pytest.approx(0.2)  # 0.2, 0.4, 0.1; the one before the window left out
    assert reader("rescale.layout_check_ms")(run) == pytest.approx(0.1)  # 0.2, 0.1, 0.1
    assert reader("rescale.table_build_ms")(run) == pytest.approx(0.6 / 3)  # one build in three events
    # Busy from each re-check's start to its segment_rf launch: 430 + 350 µs,
    # then 400 µs of two overlapping sorts; the third launches none.
    assert reader("rescale.sort_ms")(run) == pytest.approx((0.78 + 0.4) / 2)
    assert reader("engine.sweep_ms")(run) == pytest.approx(0.6)  # 0.5, 0.8, 0.6


def test_a_recheck_without_a_launch_ends_its_sort_where_its_count_starts():
    # The plain segment_rf on a CPU launches nothing: the second re-check's
    # interval runs to its count span, over 400 µs of its two sorts; the
    # first, now with neither, is left out.
    t = _window()
    t.device = [e for e in t.device if "segment_rf" not in e["name"]]
    t.host = [e for e in t.host if e["name"] != "rescale.recheck.count"] + [
        _host("rescale.recheck.count", 5150, 5880)]
    assert reader("rescale.sort_ms")(_run(t)) == pytest.approx(0.4)


def test_the_table_build_reads_zero_when_every_lookup_hits():
    t = _window()
    t.host = [e for e in t.host if e["name"] != "rescale.table_build"]
    assert reader("rescale.table_build_ms")(_run(t)) == 0.0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_gives_nothing_without_its_spans(name):
    assert reader(name)(_run(None)) is None
    assert reader(name)(_run(_window(program_spans=False))) is None


def test_busy_time_is_clipped_to_each_interval():
    t = _window()
    assert spans.busy_in(t, [(0, 1300), (1300, 1950), (4000, 5000), (9000, 9500)]) == [100, 530, 330, 0]
    assert spans.first_at_or_after(spans.kernel_starts(t, "segment_rf"), 2401, 5200) == 5200
    assert spans.first_at_or_after(spans.kernel_starts(t, "segment_rf"), 5201, 6000) is None
