"""The port's peak-RSS reader (``obs/metrics.py``): a process's own peak, in a
launched rank too.

The reference reads ``ru_maxrss``, which Linux carries across ``fork`` and
``exec``: a rank started by a launcher with a larger peak reports the
launcher's. The port reads ``VmHWM`` of ``/proc/self/status`` (the peak of
this process's own address space), or a running maximum of ``VmRSS`` where
the kernel reports no ``VmHWM``, and ``ru_maxrss`` only without ``/proc``.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.obs import metrics as OM

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CHILD = "from repro_torch.obs import metrics as OM; f, mb = OM.read_peak_rss(); print(f, mb, OM.peak_rss_mb())"


def test_a_launched_process_reads_its_own_peak_not_its_launchers():
    big = np.ones(100_000_000, dtype=np.float32)  # 400 MB, every page written
    big[::4096] += 1.0
    _, parent_peak = OM.read_peak_rss()
    del big
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, capture_output=True, text=True, check=True)
    field, child_peak, again = out.stdout.split()
    assert parent_peak > 400
    assert field in ("VmHWM", "VmRSS") and float(again) >= float(child_peak)
    # Well under the launcher's peak: the child never held the 400 MB.
    assert float(child_peak) < parent_peak - 350, (parent_peak, child_peak)


def test_without_vmhwm_the_running_vmrss_maximum(monkeypatch):
    monkeypatch.setattr(OM, "_vmrss_peak", (0, 0.0))

    def status(kb: int) -> str:
        return f"Name:\tpython\nVmPeak:\t99999 kB\nVmRSS:\t{kb} kB\nThreads:\t1\n"

    assert OM.read_peak_rss(status(2048)) == ("VmRSS", 2.0)
    assert OM.read_peak_rss(status(1024)) == ("VmRSS", 2.0)  # the largest read so far
    assert OM.read_peak_rss(status(4096)) == ("VmRSS", 4.0)
    monkeypatch.setattr(OM, "_vmrss_peak", (os.getpid() + 1, 99.0))  # another process's maximum
    assert OM.read_peak_rss(status(1024)) == ("VmRSS", 1.0)
    assert OM.read_peak_rss("VmHWM:\t5120 kB\nVmRSS:\t1024 kB\n") == ("VmHWM", 5.0)


def test_without_proc_status_ru_maxrss(monkeypatch, tmp_path):
    monkeypatch.setattr(OM, "_STATUS", str(tmp_path / "no-such-file"))
    field, mb = OM.read_peak_rss()
    assert field == "ru_maxrss" and mb > 0


@pytest.mark.parametrize("index,count", [(0, 1), (1, 3)])
def test_record_peak_rss_publishes_the_reader(index, count):
    reg = OM.MetricsRegistry()
    mb = OM.record_peak_rss(reg, process_index=index, process_count=count)
    snap = reg.snapshot()
    assert snap[f"process.peak_rss_mb.p{index}"] == pytest.approx(mb) and mb > 0
    assert OM.peak_rss_mb() >= mb
    assert all(snap[f"process.peak_rss_mb.p{i}"] == 0.0 for i in range(count) if i != index)


# --------------------------------------------- trace export and event logs
# ``obs/trace_export.py`` and ``obs/log.py`` are copies of the reference's:
# the same tracer spans export to the same trace structure, and the same
# events serialize to the same JSONL, in either package.
from repro.obs import log as J_OL  # noqa: E402
from repro.obs import trace as J_OT  # noqa: E402
from repro.obs import trace_export as J_OX  # noqa: E402
from repro_torch.obs import log as OL  # noqa: E402
from repro_torch.obs import trace as OT  # noqa: E402
from repro_torch.obs import trace_export as OX  # noqa: E402


def _traced(n=3, process=0, T=OT, X=OX):
    t = T.Tracer(capacity=64)
    for i in range(n):
        with t.span(f"ingest.batch{i}"):
            pass
        with t.span("rung.monitor"):
            pass
    return X.chrome_trace(t, process=process, process_name=f"proc{process}")


def _shape(trace):
    """A trace without its times: what two runs of one script share."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in trace["traceEvents"]], \
        {k: v for k, v in trace["otherData"].items()}


def test_chrome_trace_structure_equals_reference():
    tr = _traced(n=2)
    assert OX.validate_chrome_trace(tr) == []
    events = tr["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == 4 and {e["name"] for e in events if e["ph"] == "M"} == {"process_name", "thread_name"}
    assert {e["args"]["name"] for e in events if e["name"] == "thread_name"} == {"ingest", "rung"}
    assert len({e["cat"]: e["tid"] for e in xs}) == 2
    assert all(isinstance(e["ts"], float) and e["dur"] >= 0.0 for e in xs)
    assert _shape(tr) == _shape(_traced(n=2, T=J_OT, X=J_OX))


def test_merge_rebases_and_keeps_pids():
    merged = OX.merge_traces([_traced(process=0), _traced(process=1)])
    assert OX.validate_chrome_trace(merged) == []
    xs = [e for e in merged["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {0, 1} and min(e["ts"] for e in xs) == 0.0
    assert merged["otherData"]["p0.spans_recorded"] == merged["otherData"]["p1.spans_recorded"] == 6
    assert J_OX.validate_chrome_trace(merged) == []


def test_write_is_plain_json(tmp_path):
    import json

    p = tmp_path / "trace.json"
    OX.write_chrome_trace(str(p), _traced())
    assert OX.validate_chrome_trace(json.loads(p.read_text())) == []


@pytest.mark.parametrize("bad,problem", [
    ([], "trace is not a JSON object"),
    ({"traceEvents": []}, "traceEvents missing or empty"),
    ({"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 0.0, "dur": -1.0}]}, "negative dur"),
    ({"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0}]}, "no complete ('X') span events"),
    ({"traceEvents": [{"ph": "B", "name": "a", "pid": 0, "tid": 0}]}, "unsupported ph"),
    ({"traceEvents": [{"ph": "X", "name": "a", "tid": 0, "ts": 0.0, "dur": 1.0}]}, "missing pid"),
])
def test_validate_rejects_malformed_as_the_reference(bad, problem):
    got = OX.validate_chrome_trace(bad)
    assert any(problem in p for p in got) and got == J_OX.validate_chrome_trace(bad)


def _events(C):
    """A log of every event kind from controller module ``C`` (no engine)."""
    t = [0.0]
    ctl = C.ElasticController(4, clock=lambda: t[0], dead_after_s=1.0)
    ctl.add_hosts(2)
    t[0] = 2.0
    ctl.poll()
    ctl.report_failure([0], detect_s=0.25, restored_bytes=10, restore_s=0.5, replayed_records=1)
    rebuild = C.RebuildEvent(
        kind="full_rebuild", mode="device", committed=True, aborted=False, snapshot_edges=10, replayed_batches=2,
        splice_ops=3, flight_batches=2, dispatch_s=0.1, commit_s=0.2, seq=ctl._next_seq())
    ingest = C.IngestEvent(kind="ingest", inserted=3, deleted=1, skipped=0, escalation="partial", num_edges=9,
                           elapsed_s=0.3, monitor_s=0.1, seq=ctl._next_seq(), repair="device", rung_count=1,
                           rung_total_s=0.1, program_cache={"scatter": {"hits": 1, "misses": 1, "evictions": 0}},
                           spill={"spills": 1})
    return ctl.events + [rebuild, ingest]


@pytest.mark.parametrize("drop", [False, True], ids=["timings", "drop-timings"])
def test_events_jsonl_round_trip_equals_reference(drop):
    from repro.elastic import controller as J_ec
    from repro_torch.elastic import controller as ec

    events, jevents = _events(ec), _events(J_ec)
    text = OL.events_jsonl(events, drop_timings=drop)
    assert text == J_OL.events_jsonl(jevents, drop_timings=drop)
    assert {type(e).__name__ for e in OL.events_from_jsonl(text)} == {"ScaleEvent", "FailureEvent", "RebuildEvent",
                                                                      "IngestEvent"}
    back = OL.events_from_jsonl(text)
    assert [e.seq for e in back] == list(range(len(events)))
    if not drop:
        assert back == events
    else:
        import json

        for line in text.splitlines():
            d = json.loads(line)
            assert all(v == 0.0 for k, v in d.items() if k.endswith("_s") and isinstance(v, float))


def test_unknown_event_type_rejected():
    with pytest.raises(ValueError, match="unknown event type"):
        OL.event_from_dict({"event": "MysteryEvent"})


def test_obs_package_exports_the_references_names():
    import repro.obs as J_obs
    import repro_torch.obs as obs

    names = [n for n in dir(J_obs) if not n.startswith("_") and n not in ("log", "metrics", "trace",
                                                                            "trace_export")]
    assert all(hasattr(obs, n) for n in names)
