"""The port's spans on its two timed paths, a rescale and a query: which
spans a call records, how they nest in time, that the default tracer
records nothing and enters no profiler range, and that a span exported by
``trace_export`` lies on the profiler's own clock."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import time

import pytest
import torch

from repro_torch.core.graph import rmat_graph
from repro_torch.elastic.rescale_exec import ElasticRescaler
from repro_torch.graphs import engine as E
from repro_torch.obs import trace as OT
from repro_torch.obs import trace_export as TE

EXECUTE_CHILDREN = ["rescale.layout_check", "rescale.table_build", "rescale.migrate", "rescale.recheck"]


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(8, 6, seed=0)


@pytest.fixture
def tracer():
    t = OT.set_tracer(OT.Tracer())
    yield t
    OT.set_tracer(None)


def _inside(inner, outer) -> bool:
    return outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def _by_start(spans):
    return sorted(spans, key=lambda s: s.t0)


def test_a_rescale_records_its_steps_nested_in_time(graph):
    data = E.pack_ordered(graph.src, graph.dst, graph.num_vertices, 8, device="cpu")
    tracer = OT.Tracer()
    r = ElasticRescaler(tracer=tracer)
    r.rescale(data, 12, recheck=True)
    spans = _by_start(tracer.spans())
    assert [s.name for s in spans] == ["rescale.plan", "rescale.execute", *EXECUTE_CHILDREN[:3],
                                       "rescale.recheck", "rescale.recheck.rows", "rescale.recheck.count"]
    by = {s.name: s for s in spans}
    plan, execute, recheck = by["rescale.plan"], by["rescale.execute"], by["rescale.recheck"]
    assert plan.t1 <= execute.t0
    children = [by[n] for n in EXECUTE_CHILDREN]
    assert all(_inside(c, execute) for c in children)
    assert all(a.t1 <= b.t0 for a, b in zip(children, children[1:]))
    rows, count = by["rescale.recheck.rows"], by["rescale.recheck.count"]
    assert _inside(rows, recheck) and _inside(count, recheck) and rows.t1 <= count.t0

    tracer.clear()
    r.rescale(data, 12, recheck=True)  # the same transition: the program comes from the cache
    names = [s.name for s in _by_start(tracer.spans())]
    assert "rescale.table_build" not in names
    assert names == ["rescale.plan", "rescale.execute", "rescale.layout_check", "rescale.migrate",
                     "rescale.recheck", "rescale.recheck.rows", "rescale.recheck.count"]


@pytest.mark.parametrize("kind", ["sssp", "wcc"])
def test_a_min_sweep_query_holds_one_span_a_sweep(graph, tracer, kind):
    data = E.pack_ordered(graph.src, graph.dst, graph.num_vertices, 4, device="cpu")
    program = E.query_program(kind, num_vertices=graph.num_vertices)
    args = (data.edges, data.mask, int(graph.src[0])) if kind == "sssp" else (data.edges, data.mask)
    _, sweeps = program(*args)
    spans = tracer.spans()
    (query,) = [s for s in spans if s.name == f"query.{kind}"]
    sweep_spans = [s for s in spans if s.name == "query.sweep"]
    assert sweeps > 1 and len(sweep_spans) == sweeps and len(spans) == sweeps + 1
    assert all(_inside(s, query) for s in sweep_spans)
    assert query.t1 == max(s.t1 for s in spans)  # the last span to close


def test_a_pagerank_query_is_one_span(graph, tracer):
    data = E.pack_ordered(graph.src, graph.dst, graph.num_vertices, 4, device="cpu")
    E.query_program("pagerank", num_vertices=graph.num_vertices, iterations=3)(data.edges, data.mask, data.degrees)
    assert [s.name for s in tracer.spans()] == ["query.pagerank"]


def test_the_default_tracer_records_nothing_and_enters_no_profiler_range(graph, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    default = OT.get_tracer()
    assert not default.enabled and default.span("rescale.plan") is OT.span("query.sweep")
    data = E.pack_ordered(graph.src, graph.dst, graph.num_vertices, 8, device="cpu")
    ElasticRescaler().rescale(data, 12, recheck=True)
    E.query_program("wcc", num_vertices=graph.num_vertices)(data.edges, data.mask)
    assert len(default) == 0 and default.recorded == 0 and entered == []


def test_an_annotated_span_lies_on_the_profilers_clock():
    tracer = OT.Tracer(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("test.first"):  # a process's first profiler range pays the range's own set-up
            pass
        with tracer.span("test.sleep"):
            time.sleep(0.02)
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.sleep"]
    assert rng.is_user_annotation()
    (ev,) = [e for e in TE.chrome_trace(tracer)["traceEvents"] if e.get("ph") == "X" and e["name"] == "test.sleep"]
    assert ev["dur"] >= 20e3
    assert ev["ts"] == pytest.approx(rng.start_ns() / 1e3, abs=2e3)
    assert ev["dur"] == pytest.approx(rng.duration_ns() / 1e3, abs=2e3)
