"""The port's graph-query serving (``graphs/engine.py query_program``,
``launch/serve.py``) against the JAX package's, on the CPU.

* The tests of ``tests/test_serve.py`` run on the port with ``device="cpu"``.
  The port's ``query_program`` caches nothing (a program is a plain
  function), so its counterpart of the caching test checks that ``source``
  is an operand and that an unknown kind raises, not object identity.
* The query programs against the JAX package's ``query_program`` on a graph
  mesh of one, on ``cep_engine_data`` packs: PageRank within rtol 1e-5 (the
  two packages' scatter-adds sum in different orders), SSSP and WCC exact
  with equal iteration counts.
* The JAX package's ``ServeLoop``, controller and autoscaler and the port's,
  each over its own port ``StreamingEngine(device="cpu")`` on one stream:
  records, ``summary()`` and the event logs (``drop_timings``) are equal, a
  scale-in's reason masked where it quotes a measured p99. The JAX package's
  ``StreamingEngine`` is not run: its sharded gathers raise
  ``ShardingTypeError`` in some jax versions on the CPU.
* ``chip_smoke.py`` path 9 (b)'s trajectory, regenerated from the JAX loop,
  equals the committed ``tests/torch_serve_trajectory.json`` the smoke reads
  (``python tests/test_torch_serve.py`` rewrites it).
* A 2 × 2 gloo cluster of ``tests/torch_serve_harness.py`` takes the same k
  path, records and probe answers as one rank.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

import torch_serve_harness as SH
from repro.elastic import autoscale as J_EA
from repro.elastic import controller as J_ec
from repro.graphs import engine as J_E
from repro.launch import mesh as J_MM
from repro.launch import serve as J_LS
from repro.obs import metrics as J_OM
from repro.stream import workload as J_workload
from repro_torch.core import ordering
from repro_torch.core.graph import rmat_graph
from repro_torch.elastic import autoscale as EA
from repro_torch.elastic import controller as ec
from repro_torch.graphs import engine as E
from repro_torch.launch import serve as LS
from repro_torch.obs import metrics as OM
from repro_torch.stream import IncrementalOrderer, StreamingEngine, SyntheticStream
from repro_torch.stream.incremental import StreamConfig
from repro_torch.stream.workload import OpenLoopWorkload

JAX_PKG = types.SimpleNamespace(controller=J_ec, autoscale=J_EA, serve=J_LS, metrics=J_OM, workload=J_workload)
# The JAX-against-port loop at scale 7 (bench_serve.py --smoke's day of 48
# ticks and batch of 16), both rungs in "device" mode (the fixture's run
# below takes "differential" spans), and the cluster's shorter run of it.
SMALL = dict(SH.SCENARIO, scale=7, day_ticks=48, ingest_batch=16,
             engine=dict(span_repair="device", full_rebuild="device"))
CLUSTER = dict(SMALL, day_ticks=24)


def _engine(scale=7, regions=2, seed=0, **kw):
    g = rmat_graph(scale, 8, seed=seed)
    order = ordering.geo_order(g, seed=0)
    src, dst = g.src[order].astype(np.int64), g.dst[order].astype(np.int64)
    orderer = IncrementalOrderer(src, dst, g.num_vertices, regions=regions)
    return g, StreamingEngine(orderer, device="cpu", **kw)


# ----------------------------------------------------------- query programs
def test_query_programs_match_one_shot_entry_points():
    _, engine = _engine()
    data = engine.data
    kw = dict(num_vertices=data.num_vertices, group=data.group)
    ranks = E.query_program("pagerank", iterations=20, **kw)(data.edges, data.mask, data.degrees)
    np.testing.assert_allclose(ranks.numpy(), E.pagerank(data).numpy(), rtol=1e-6, atol=1e-9)
    dist, iters = E.query_program("sssp", **kw)(data.edges, data.mask, 3)
    ref_dist, ref_iters = E.sssp(data, source=3)
    np.testing.assert_array_equal(dist.numpy(), ref_dist.numpy())
    assert iters == ref_iters
    lab, _ = E.query_program("wcc", **kw)(data.edges, data.mask)
    np.testing.assert_array_equal(lab.numpy(), E.wcc(data)[0].numpy())


def test_query_program_source_is_an_operand_and_bad_kinds_raise():
    _, engine = _engine()
    data = engine.data
    kw = dict(num_vertices=data.num_vertices, group=data.group)
    prog = E.query_program("sssp", **kw)
    # Different sources go through one program — source is an operand.
    d0, _ = prog(data.edges, data.mask, 0)
    d5, _ = prog(data.edges, data.mask, 5)
    assert d0[0] == 0.0 and d5[5] == 0.0
    assert not torch.equal(d0, d5)
    with pytest.raises(ValueError):
        E.query_program("nope", **kw)


@pytest.fixture(scope="module")
def packs():
    g = rmat_graph(8, 6, seed=0)
    order = ordering.geo_order(g, seed=0)
    return g, order, J_MM.make_graph_mesh(1)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("kind", ["pagerank", "sssp", "wcc"])
def test_query_programs_match_reference(packs, k, kind):
    g, order, mesh = packs
    jdata = J_E.cep_engine_data(g, order, k)
    data = E.engine_data_from_arrays(
        np.asarray(jdata.edges), np.asarray(jdata.mask), np.asarray(jdata.degrees), num_vertices=jdata.num_vertices,
        k=k, mirrors=jdata.mirrors, replication_factor=jdata.replication_factor, num_edges=jdata.num_edges,
        device="cpu")
    want_prog = J_E.query_program(kind, num_vertices=g.num_vertices, mesh=mesh, iterations=20)
    got_prog = E.query_program(kind, num_vertices=g.num_vertices, iterations=20)
    if kind == "pagerank":
        want = want_prog(jdata.edges, jdata.mask, jdata.degrees)
        got = got_prog(data.edges, data.mask, data.degrees)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
        return
    args = (int(np.argmax(np.asarray(jdata.degrees))),) if kind == "sssp" else ()
    want, want_it = want_prog(jdata.edges, jdata.mask, *args)
    got, got_it = got_prog(data.edges, data.mask, *args)
    assert got_it == want_it
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_queries_survive_rescale_and_full_rebuild():
    g, engine = _engine(regions=4)
    qe = LS.QueryEngine(engine)
    base, _ = qe.query("pagerank")
    # Rescale under the query engine's feet: same graph, new layout.
    engine.rescale(3)
    engine.verify_bit_identity()
    after, _ = qe.query("pagerank")
    np.testing.assert_allclose(base.numpy(), after.numpy(), rtol=1e-5, atol=1e-8)

    # Async full rebuild: ingest with thresholds that force the full rung,
    # then query the committed pack — answers must reflect the NEW graph.
    g2 = rmat_graph(7, 8, seed=3)
    order = ordering.geo_order(g2, seed=0)
    src, dst = g2.src[order].astype(np.int64), g2.dst[order].astype(np.int64)
    cfg = StreamConfig(partial_drift=1.01, full_drift=1.02, span_regions=2)
    orderer = IncrementalOrderer(src, dst, g2.num_vertices, regions=4, config=cfg)
    eng2 = StreamingEngine(orderer, device="cpu", span_repair="device", full_rebuild="geo", rebuild_flight=1)
    qe2 = LS.QueryEngine(eng2)
    stream = SyntheticStream(g2, batch_size=64, seed=2, burst_every=3, burst_factor=4)
    committed = 0
    for _ in range(20):
        eng2.ingest(stream.batch())
        eng2.monitor()
        _, elapsed = qe2.query("wcc")  # a query between every batch
        assert elapsed > 0.0
        committed = sum(1 for r in eng2.drain_rebuild_events() if r["committed"])
        if committed:
            break
    assert committed >= 1, "stream never committed a full rebuild"
    eng2.verify_bit_identity()
    # The post-rebuild pack answers queries consistently with a from-scratch
    # engine over the same live edge set.
    (lab, _), _ = qe2.query("wcc")
    live = orderer.snapshot()
    fresh = IncrementalOrderer(live[0], live[1], g2.num_vertices, regions=4)
    ref, _ = E.wcc(StreamingEngine(fresh, device="cpu").data)
    np.testing.assert_array_equal(lab.numpy(), ref.numpy())


def test_query_engine_single_timing_read_feeds_registry():
    reg = OM.MetricsRegistry()
    _, engine = _engine()
    qe = LS.QueryEngine(engine, registry=reg)
    _, e1 = qe.query("sssp", source=1)
    _, e2 = qe.query("wcc")
    h = reg.histogram("serve.query_measured_s")
    assert h.total == 2 and reg.counter("serve.queries").value == 2.0
    # The recorded samples ARE the returned elapsed values (one read each).
    assert sorted(np.asarray(h._samples).tolist()) == sorted([e1, e2])


# ---------------------------------------------------------------- serve loop
def _loop(ticks=24, base_rate=6.0, k0=2, autoscaler=True):
    g, engine = _engine(regions=k0)
    reg = OM.MetricsRegistry()
    ref = []
    ctl = ec.ElasticController(k0, clock=lambda: ref[0].now if ref else 0.0, metrics_registry=reg)
    ctl.attach_stream(engine)
    if autoscaler:
        ctl.attach_autoscaler(EA.AutoscalePolicy(EA.AutoscaleConfig(
            k_min=1, k_max=8, queue_high_per_host=2.0, queue_low=0.5, ema=0.6, out_cooldown_s=4.0,
            in_cooldown_s=8.0)))
    workload = OpenLoopWorkload(num_vertices=g.num_vertices, base_rate=base_rate, day_ticks=ticks,
                                diurnal_amp=0.7, burst_every=0, seed=0)
    updates = SyntheticStream(g, batch_size=8, seed=0)
    loop = LS.ServeLoop(ctl, workload, updates=updates, registry=reg, config=LS.ServeConfig(probe_every=4))
    ref.append(loop)
    return loop, ctl, engine, reg


def test_serve_loop_accounting_is_consistent():
    loop, ctl, engine, reg = _loop()
    loop.run(24)
    loop.drain()
    s = loop.summary()
    assert s["served"] == len(loop.records) > 0
    assert s["backlog"] == 0  # drain retired everything
    assert s["slo_violations"] == sum(1 for r in loop.records if r.violated)
    assert reg.histogram("serve.latency_s").total == s["served"]
    # FIFO on the virtual timeline: retirement ticks are non-decreasing and
    # nothing retires before it arrives.
    ticks = [r.tick for r in loop.records]
    assert ticks == sorted(ticks)
    assert all(r.tick >= r.arrival_tick for r in loop.records)
    # Modeled latency = wait + service, exactly.
    c = loop.config
    for r in loop.records:
        assert r.latency_s == pytest.approx((r.tick - r.arrival_tick) * c.tick_s + c.tick_s / c.per_host_rate)
    # Probes ran and measured real time.
    assert any(r.measured_s > 0 for r in loop.records)
    # One ingest per tick rode along, all on the shared seq log.
    ingests = [e for e in ctl.events if e.kind == "ingest"]
    assert len(ingests) == 24
    seqs = [e.seq for e in ctl.events]
    assert seqs == sorted(seqs)


def test_serve_loop_autoscales_and_stays_bit_identical():
    loop, ctl, engine, _ = _loop(ticks=32, base_rate=10.0)
    loop.run(32)
    assert loop.scale_events, "load never moved k"
    assert all(e.executed for e in loop.scale_events)
    assert engine.k == ctl.k
    assert engine.verify_bit_identity()
    s = loop.summary()
    assert len(s["migrated_bytes_per_decision"]) == len(loop.scale_events)
    assert len(s["moved_edges_per_decision"]) == len(loop.scale_events)
    assert all(m > 0 for m in s["moved_edges_per_decision"])
    assert s["k_path"][0] == 2 and len(s["k_path"]) == len(loop.scale_events) + 1


def test_serve_loop_requires_stream_and_sheds_at_capacity():
    g, _ = _engine()
    ctl = ec.ElasticController(2)
    workload = OpenLoopWorkload(num_vertices=g.num_vertices, base_rate=4.0)
    with pytest.raises(ValueError):
        LS.ServeLoop(ctl, workload)
    # Admission bound: a tiny queue cap sheds the overflow and counts it.
    loop, *_ = _loop(autoscaler=False)
    loop.config = LS.ServeConfig(queue_cap=2, probe_every=0, per_host_rate=0.5)
    loop.run(12)
    assert loop.shed > 0
    assert len(loop.queue) <= 2


def _serve_stack(device=None) -> LS.ServeLoop:
    """A user's path to a serve loop: engine on ``device``, controller, loop."""
    g = rmat_graph(6, 4, seed=0)
    orderer = IncrementalOrderer(g.src.astype(np.int64), g.dst.astype(np.int64), g.num_vertices, regions=2)
    ctl = ec.ElasticController(2)
    ctl.attach_stream(StreamingEngine(orderer, device=device))
    return LS.ServeLoop(ctl, OpenLoopWorkload(num_vertices=g.num_vertices, base_rate=4.0))


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """``main()``, and the engine a ``QueryEngine`` and ``ServeLoop`` read,
    run on CUDA by default: without a card they raise instead of running on
    the CPU."""
    assert _serve_stack("cpu").queries.query("wcc")[0][0].device.type == "cpu"
    if torch.cuda.is_available():
        assert _serve_stack().queries.query("wcc")[0][0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LS.main(["--ticks", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _serve_stack()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _serve_stack("cuda")


def test_main_on_the_cpu_prints_its_summary(capsys):
    LS.main(["--ticks", "24", "--scale", "7", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "queries over 24 ticks" in out and "on cpu" in out and "autoscaler:" in out


# ----------------------------------------------- the JAX loop against the port's
def _records(loop) -> list:
    return [dataclasses.astuple(r) for r in loop.records]


def test_jax_loop_and_port_loop_agree():
    ordered = SH.build_ordered(**SMALL)
    runs = {}
    for name, pkg in (("jax", JAX_PKG), ("port", None)):
        loop, ctl, policy, _ = SH.build_loop(ordered, pkg=pkg, device="cpu", **dict(SMALL, probe_every=0))
        SH.run_scenario(loop, **SMALL)
        runs[name] = (loop, ctl, policy)
    (jloop, jctl, jpolicy), (loop, ctl, policy) = runs["jax"], runs["port"]
    assert loop.scale_events, "the scenario never moved k"
    assert _records(loop) == _records(jloop)
    mask = lambda s: {k: (SH.mask_p99(v) if isinstance(v, str) else v) for k, v in s.items()}  # noqa: E731
    assert mask(loop.summary()) == mask(jloop.summary())
    assert SH.mask_p99(ctl.events_jsonl(drop_timings=True)) == SH.mask_p99(jctl.events_jsonl(drop_timings=True))
    assert SH.trajectory(loop, policy) == SH.trajectory(jloop, jpolicy)
    # Probes on: real queries on the live pack change nothing the loop decides.
    loop2, _, policy2, _ = SH.build_loop(ordered, device="cpu", **SMALL)
    probes = SH.record_probes(loop2)
    SH.run_scenario(loop2, **SMALL)
    assert len(probes) > 0 and any(r.measured_s > 0 for r in loop2.records)
    assert SH.trajectory(loop2, policy2) == SH.trajectory(loop, policy)


def _fixture_trajectory() -> dict:
    """Path 9 (b)'s trajectory: the JAX package's loop over a port CPU engine.
    Its probes stay off (the JAX query programs take a mesh, the port's pack
    has none); probes change nothing a trajectory holds (the test above)."""
    s = SH.SCENARIO
    loop, ctl, policy, eng = SH.build_loop(SH.build_ordered(**s), pkg=JAX_PKG, device="cpu",
                                           **dict(s, probe_every=0))
    SH.run_scenario(loop, **s)
    assert eng.rung_counts["partial"] > 0 and eng.rung_counts["full"] > 0, "a rung never fired"
    return SH.trajectory(loop, policy)


def test_path9b_trajectory_equals_the_committed_fixture():
    got = _fixture_trajectory()
    assert got["scale_outs"] >= 2 and got["scale_ins"] >= 2 and got["flap_pairs"] == 0
    assert all(d["executed"] for d in got["decisions"])
    assert got == json.loads(SH.TRAJECTORY_FILE.read_text())


# ------------------------------------------------------------ ranks
def _assert_same_probes(got, want):
    assert [p[:2] + p[3:] for p in got["probes"]] == [p[:2] + p[3:] for p in want["probes"]]  # tick, kind, iters
    assert [p[2] for p in got["probes"]] == [p[2] for p in want["probes"]]  # sources
    for (_, kind, _, _), a, b in zip(got["probes"], got["answers"], want["answers"]):
        if kind == "pagerank":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(a, b)


def test_cluster_of_2x2_gloo_ranks_equals_one_rank(tmp_path):
    loop, ctl, policy, _ = SH.build_loop(SH.build_ordered(**CLUSTER), device="cpu", **CLUSTER)
    probes = SH.record_probes(loop)
    loop.queries.warm()
    del probes[:]
    SH.run_scenario(loop, **CLUSTER)
    one = dict(trajectory=SH.trajectory(loop, policy), probes=[[t, k, s, i] for t, k, s, _, i in probes],
               answers=[a for *_, a, _ in probes], events_jsonl=SH.mask_p99(ctl.events_jsonl(drop_timings=True)))
    assert len(one["trajectory"]["k_path"]) > 2 and len(probes) > 0
    ranks = SH.run_cluster(tmp_path, backend="gloo", n_procs=2, devs_per_proc=2, devices=["cpu"] * 4,
                           scenario=CLUSTER, timeout=180.0)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3] and {r["size"] for r in ranks} == {4}
    for r in ranks:
        assert r["trajectory"] == one["trajectory"]
        _assert_same_probes(r, one)
    # The ranks' logs agree with one another; the one-rank log differs only
    # in the bytes a rescale moves across ranks.
    assert len({r["events_jsonl"] for r in ranks}) == 1


if __name__ == "__main__":  # PYTHONPATH=src python tests/test_torch_serve.py: rewrite the fixture
    SH.TRAJECTORY_FILE.write_text(json.dumps(_fixture_trajectory(), indent=1) + "\n")
    print(f"wrote {SH.TRAJECTORY_FILE}", file=sys.stderr)
