"""The port's control plane against the JAX package's on the same inputs:
``elastic/{resharder,expert_place,controller}.py``.

* The resharder and expert placement are numpy copies: their plans, moves and
  orders equal the reference's exactly.
* The controller tests of ``tests/test_runtime.py`` run on the port.
* The JAX package's ``ElasticController`` (it imports no JAX at its top) and
  the port's take the same heartbeat / ``poll`` / ``add_hosts`` /
  ``autoscale`` / ``report_failure`` script on one injected clock; their
  ``events_jsonl(drop_timings=True)`` are byte-equal.
* With an engine attached, every decision executes: a packed pack under the
  port's ``ElasticRescaler`` against the JAX one under the reference's, and
  two port ``StreamingEngine(device="cpu")`` engines on one stream, one under
  each controller, with the rungs on: the event logs and slot arrays are
  equal, and each pack stays bit-identical to ``pack_slots``.

Exact everywhere; the controllers' timing fields are zeroed by
``drop_timings`` (wall clocks differ between two runs).
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import json

import numpy as np
import pytest

from repro.core import cep as J_cep
from repro.elastic import autoscale as J_EA
from repro.elastic import controller as J_ec
from repro.elastic import expert_place as J_ep
from repro.elastic import resharder as J_rs
from repro.graphs import engine as J_E
from repro.obs import log as J_OL
from repro.obs import metrics as J_OM
from repro_torch.core import cep, ordering
from repro_torch.core.graph import rmat_graph
from repro_torch.elastic import autoscale as EA
from repro_torch.elastic import controller as ec
from repro_torch.elastic import expert_place as ep
from repro_torch.elastic import resharder as rs
from repro_torch.graphs import engine as E
from repro_torch.launch.mesh import make_graph_group
from repro_torch.obs import log as OL
from repro_torch.obs import metrics as OM
from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream


# ------------------------------------------------------------------ resharder
@pytest.mark.parametrize("k_old,k_new", [(8, 9), (16, 12), (3, 7)])
def test_apply_reshard_preserves_data_and_moves_minimum(k_old, k_new):
    n = 10_000
    rng = np.random.default_rng(0)
    flat = rng.standard_normal(n).astype(np.float32)
    old = [rs.gather_host_shard(flat, k_old, h) for h in range(k_old)]
    new, moved = rs.apply_reshard(old, n, k_old, k_new)
    np.testing.assert_array_equal(np.concatenate(new), flat)
    assert moved == cep.migrated_edges_exact(n, k_old, k_new)
    if k_new == k_old + 1:
        assert moved < n * k_old / (k_old + 1)  # beats hash-based reshuffle
    j_new, j_moved = J_rs.apply_reshard([J_rs.gather_host_shard(flat, k_old, h) for h in range(k_old)],
                                        n, k_old, k_new)
    assert moved == j_moved and all(np.array_equal(a, b) for a, b in zip(new, j_new))


def test_reshard_plan_summary_equals_reference():
    shapes = {"w": ((1024, 1024), 4), "b": ((1024,), 4)}
    s = rs.plan_reshard(shapes, 16, 17).summary()
    assert 0 < s["moved_frac"] < 0.6
    assert s["moved_frac"] < s["random_frac"]
    assert s == J_rs.plan_reshard(shapes, 16, 17).summary()


# ------------------------------------------------------- expert placement
def test_expert_placement_reduces_cross_group_traffic():
    rng = np.random.default_rng(1)
    e = 32
    stats = rng.random((e, e)) * 0.1  # two co-activation communities of 16 experts
    stats[:16, :16] += 5.0
    stats[16:, 16:] += 5.0
    stats = (stats + stats.T) / 2
    np.fill_diagonal(stats, 0)
    order = ep.order_experts(stats)
    assert sorted(order.tolist()) == list(range(e))
    np.testing.assert_array_equal(order, J_ep.order_experts(stats))
    placed = ep.ExpertPlacement(order, k_groups=2)
    shuffled = ep.ExpertPlacement(np.random.default_rng(2).permutation(e), k_groups=2)
    t_placed = ep.cross_group_traffic(stats, placed)
    assert t_placed < 0.7 * ep.cross_group_traffic(stats, shuffled)
    assert t_placed == J_ep.cross_group_traffic(stats, J_ep.ExpertPlacement(order, k_groups=2))
    placed2, moved = placed.rescale(3)  # elastic EP resize: O(1) plan, bounded movement
    j_placed2, j_moved = J_ep.ExpertPlacement(order, k_groups=2).rescale(3)
    assert placed2.k_groups == 3 and 0 < moved <= e and moved == j_moved
    assert placed2.groups() == j_placed2.groups()


def test_coactivation_graph_from_routing_trace_equals_reference():
    ids = np.random.default_rng(3).integers(0, 16, size=(500, 2))
    g, jg = ep.coactivation_graph(ids, 16), J_ep.coactivation_graph(ids, 16)
    assert g.num_vertices == 16 and g.num_edges > 0
    np.testing.assert_array_equal(g.src, jg.src)
    np.testing.assert_array_equal(g.dst, jg.dst)


# ----------------------------------------------------------------- controller
def test_controller_detects_preemption_and_straggler():
    t = [0.0]
    ctl = ec.ElasticController(4, dead_after_s=5.0, straggler_lag_steps=10, clock=lambda: t[0])
    for h in range(4):
        ctl.heartbeat(h, step=100)
    t[0] = 4.0
    for h in range(3):  # host 3 goes silent (spot preemption)
        ctl.heartbeat(h, step=110)
    t[0] = 7.0
    ev = ctl.poll()
    assert ev and ev.kind == "scale_in" and ev.lost_hosts == (3,) and ctl.k == 3
    assert 0 < ev.plan_edges_moved_frac < 1
    for step in (150, 200):  # straggler: host 2 stops progressing
        for h in (0, 1):
            ctl.heartbeat(h, step)
        ctl.heartbeat(2, 111)
        t[0] += 1.0
    ev2 = ctl.poll()
    assert ev2 and ev2.kind == "straggler" and 2 in ev2.lost_hosts
    ev3 = ctl.add_hosts(2)
    assert ev3.kind == "scale_out" and ctl.k == 4
    assert (ev.seq, ev2.seq, ev3.seq) == (0, 1, 2)
    assert [e.seq for e in ctl.events] == [0, 1, 2]


def test_scale_event_seq_is_monotonic_across_controllers_and_kinds():
    t = [0.0]
    ctl = ec.ElasticController(3, dead_after_s=5.0, clock=lambda: t[0])
    events = [ctl.add_hosts(1), ctl.add_hosts(2)]
    t[0] = 1.0
    for h in range(4):
        ctl.heartbeat(h, 1)  # hosts 4, 5 never beat
    t[0] = 6.0
    events.append(ctl.poll())
    assert all(e is not None for e in events)
    seqs = [e.seq for e in events]
    assert seqs == [0, 1, 2] and [e.seq for e in ctl.events] == seqs
    assert ec.ElasticController(2).add_hosts(1).seq == 0  # a fresh controller restarts its counter


def test_mark_event_rate_gauge_runs_on_injected_clock():
    t = [0.0]
    reg = OM.MetricsRegistry()
    ctl = ec.ElasticController(2, clock=lambda: t[0], metrics_registry=reg)
    gauge = reg.gauge("controller.events_per_s")
    ctl.add_hosts(1)
    assert gauge.value == 0.0  # one event: no inter-event interval yet
    t[0] = 2.0  # exactly 0.5 events/s on the FAKE timeline
    ctl.add_hosts(1)
    assert gauge.value == pytest.approx(0.5)
    t[0] = 2.5  # 2 events/s raw → EMA 0.8*0.5 + 0.2*2.0
    ctl.add_hosts(1)
    assert gauge.value == pytest.approx(0.8 * 0.5 + 0.2 * 2.0)
    before = gauge.value
    ctl.add_hosts(1)  # a frozen clock between events leaves the gauge untouched
    assert gauge.value == before


def test_poll_eviction_clamps_at_k_min_floor():
    t = [0.0]
    ctl = ec.ElasticController(4, dead_after_s=5.0, clock=lambda: t[0], k_min=2)
    ctl.heartbeat(2, step=1)
    t[0] = 1.0
    ctl.heartbeat(3, step=1)  # host 3 beat most recently, then 2, then 0/1
    t[0] = 10.0  # ALL hosts are now past dead_after_s
    ev = ctl.poll()
    assert ev is not None and ev.kind == "scale_in" and ctl.k == 2
    assert set(ev.lost_hosts) == {0, 1}  # stalest evicted, freshest retained
    assert ctl.hosts[2].alive and ctl.hosts[3].alive
    assert "clamped at k_min=2" in ev.reason and "[2, 3]" in ev.reason
    ctl2 = ec.ElasticController(1, dead_after_s=5.0, clock=lambda: t[0], k_min=1)
    t[0] += 10.0  # the lone host goes dark — but it IS the floor
    assert ctl2.poll() is None and ctl2.k == 1
    with pytest.raises(ValueError):
        ec.ElasticController(2, k_min=0)


# ------------------------------------------------ the same script, both packages
def _script(pkg, name: str):
    """Run control script ``name`` on package ``pkg``'s controller (``pkg`` is
    (controller module, autoscale module, metrics module)) on an injected
    clock; returns the controller."""
    C, A, M = pkg
    t = [0.0]
    reg = M.MetricsRegistry()
    ctl = C.ElasticController(6, dead_after_s=5.0, straggler_lag_steps=10, clock=lambda: t[0],
                              metrics_registry=reg, k_min=2, state_elements=123_457)
    cfg = A.AutoscaleConfig(k_min=2, k_max=12, ema=1.0, out_cooldown_s=3.0, in_cooldown_s=6.0, queue_low=0.5)
    ctl.attach_autoscaler(A.AutoscalePolicy(cfg))
    for h in range(6):
        ctl.heartbeat(h, 10)
    if name in ("membership", "mixed"):
        t[0] = 3.0
        for h in range(5):
            ctl.heartbeat(h, 20)  # host 5 goes silent
        t[0] = 8.5
        ctl.poll()
        for step in (40, 80):  # host 4 lags
            for h in range(4):
                ctl.heartbeat(h, step)
            t[0] += 1.0
        ctl.poll()
        ctl.add_hosts(3)
        ctl.poll()  # nothing to do
    if name in ("autoscale", "mixed"):
        ctl.autoscale()  # no signal: held
        reg.histogram("controller.batch_wall_s").observe(0.01)
        ctl.note_backlog(100)
        t[0] += 1.0
        ctl.autoscale()  # out
        t[0] += 1.0
        ctl.autoscale()  # cooldown
        ctl.note_backlog(0)
        t[0] += 10.0
        ctl.autoscale()  # in
    if name in ("failure", "mixed"):
        ctl.report_failure([1, 2], detect_s=0.25, restored_bytes=4096, replayed_records=3, restore_s=0.5)
        ctl.report_failure([1, 3])  # 1 is already dead
        ctl.report_failure(sorted(h.host_id for h in ctl.hosts.values() if h.alive))  # the floor clamps
    return ctl


PKG = (ec, EA, OM)
J_PKG = (J_ec, J_EA, J_OM)


@pytest.mark.parametrize("name", ["membership", "autoscale", "failure", "mixed"])
def test_scripted_controllers_log_byte_equal(name):
    ctl, jctl = _script(PKG, name), _script(J_PKG, name)
    assert len(ctl.events) > 0
    assert ctl.events_jsonl(drop_timings=True) == jctl.events_jsonl(drop_timings=True)
    assert ctl.events_jsonl() == jctl.events_jsonl()  # an injected clock: even the timings agree
    assert [e.seq for e in ctl.events] == list(range(len(ctl.events)))
    assert ctl.k == jctl.k
    assert [(d.decision, d.held_by) for d in ctl.autoscaler.log] == [
        (d.decision, d.held_by) for d in jctl.autoscaler.log]
    # Each package reads the other's log back into its own event types.
    assert J_OL.events_jsonl(J_OL.events_from_jsonl(ctl.events_jsonl())) == ctl.events_jsonl()
    assert OL.events_from_jsonl(jctl.events_jsonl()) == ctl.events


# ---------------------------------------------------- an attached packed engine
@pytest.fixture(scope="module")
def ordered():
    g = rmat_graph(9, 8, seed=0)
    order = ordering.geo_order(g, seed=0)
    return g, g.src[order].astype(np.int64), g.dst[order].astype(np.int64)


@pytest.mark.parametrize("group", [False, True], ids=["pack", "group-of-one"])
def test_attached_pack_rescales_like_the_reference(ordered, group):
    """Every decision executes on the attached pack: the port's
    ``ElasticRescaler`` and the reference's migrate the same edges, the
    events match byte for byte, and the migrated pack equals a fresh pack."""
    g, src, dst = ordered
    t = [0.0]
    ctl = ec.ElasticController(8, dead_after_s=5.0, clock=lambda: t[0])
    jctl = J_ec.ElasticController(8, dead_after_s=5.0, clock=lambda: t[0])
    data = E.pack_ordered(src, dst, g.num_vertices, 8, device="cpu")
    ctl.attach_engine(data, group=make_graph_group("cpu") if group else None)
    jctl.attach_engine(J_E.pack_ordered(src, dst, g.num_vertices, 8))
    t[0] = 2.0
    for c in (ctl, jctl):
        for h in range(6):
            c.heartbeat(h, 1)  # hosts 6 and 7 never beat
    t[0] = 6.0
    evs = [ctl.poll(), ctl.add_hosts(3)]
    jevs = [jctl.poll(), jctl.add_hosts(3)]
    assert all(e.executed for e in evs + jevs) and ctl.engine_data.k == jctl.engine_data.k == 9
    assert ctl.events_jsonl(drop_timings=True) == jctl.events_jsonl(drop_timings=True)
    assert [s.migrated_edges for s in ctl.rescale_stats] == [s.migrated_edges for s in jctl.rescale_stats]
    fresh = E.pack_ordered(src, dst, g.num_vertices, 9, device="cpu")
    got = E.unshard_engine_data(ctl.engine_data) if group else ctl.engine_data
    assert np.array_equal(got.edges.numpy(), fresh.edges.numpy())
    assert np.array_equal(np.asarray(jctl.engine_data.edges), fresh.edges.numpy())


# --------------------------------------------- two port engines, both controllers
RUNGS = {
    "device": dict(span_repair="device", full_rebuild="device", rebuild_flight=1),
    "differential": dict(span_repair="differential", full_rebuild="differential", rebuild_flight=2),
    "host-geo": dict(span_repair="host", full_rebuild="geo", rebuild_flight=0),
}


def _stream_run(C, rungs: str, ordered):
    """One port engine on the test stream under controller module ``C``:
    ingests with the monitor, a forced full rung, a host lost to ``poll``,
    a scale-out, a backlog-driven autoscale and a reported failure, the pack
    checked after every event. Returns (controller, orderer)."""
    g, src, dst = ordered
    t = [0.0]
    cfg = StreamConfig(partial_drift=1.0, full_drift=99.0, span_regions=2, k_min=4, k_max=32)
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=6, config=cfg)
    eng = StreamingEngine(o, device="cpu", **RUNGS[rungs])
    reg = (OM if C is ec else J_OM).MetricsRegistry()
    A = EA if C is ec else J_EA
    ctl = C.ElasticController(6, dead_after_s=5.0, clock=lambda: t[0], metrics_registry=reg)
    ctl.attach_stream(eng)
    ctl.attach_autoscaler(A.AutoscalePolicy(A.AutoscaleConfig(k_min=2, k_max=10, ema=1.0, out_cooldown_s=1.0,
                                                                in_cooldown_s=2.0)))
    stream = SyntheticStream(g, batch_size=48, seed=5)
    for b in range(9):
        t[0] += 1.0
        for h in ctl.hosts:
            if h != 5 or b < 2:
                ctl.heartbeat(h, b)
        if b == 3:
            o.drift = lambda: 200.0  # over full_drift: the full rung fires
        ctl.ingest(stream.batch())
        if b == 3:
            del o.drift
        eng.verify_bit_identity()
        if b == 4:
            t[0] += 5.0
            assert ctl.poll().executed  # host 5 went silent: 6 → 5
        if b == 5:
            assert ctl.add_hosts(2).executed
        if b == 6:
            ctl.note_backlog(200)
            assert ctl.autoscale().executed
        if b == 7:
            fev, sev = ctl.report_failure([0], detect_s=0.5)
            assert sev.executed
        eng.verify_bit_identity()
    return ctl, o


@pytest.mark.parametrize("rungs", sorted(RUNGS))
def test_port_engines_under_both_controllers_log_equal(ordered, rungs):
    ctl, o = _stream_run(ec, rungs, ordered)
    jctl, jo = _stream_run(J_ec, rungs, ordered)
    text = ctl.events_jsonl(drop_timings=True)
    assert text == jctl.events_jsonl(drop_timings=True)
    kinds = [json.loads(line)["event"] for line in text.splitlines()]
    assert {"IngestEvent", "ScaleEvent", "FailureEvent"} <= set(kinds)
    escalations = {json.loads(line).get("escalation") for line in text.splitlines()}
    assert {"partial", "full"} <= escalations  # the rungs fired under both controllers
    assert [e.seq for e in ctl.events] == list(range(len(ctl.events)))
    for a, b in ((o.slot_src, jo.slot_src), (o.slot_dst, jo.slot_dst), (o.slot_valid, jo.slot_valid)):
        np.testing.assert_array_equal(a, b)
    assert ctl.stream.k == jctl.stream.k == o.regions


def test_ingest_without_a_stream_and_checkpoint_before_it_raise():
    ctl = ec.ElasticController(2)
    with pytest.raises(ValueError, match="attach_stream"):
        ctl.ingest(None)
    with pytest.raises(ValueError, match="attach_stream"):
        ctl.attach_checkpoint(object())


def test_cep_plan_fraction_without_an_engine_equals_reference():
    for k_old, k_new in ((4, 5), (16, 9), (7, 7)):
        ctl, jctl = ec.ElasticController(k_old), J_ec.ElasticController(k_old)
        if k_new > k_old:
            a, b = ctl.add_hosts(k_new - k_old), jctl.add_hosts(k_new - k_old)
        else:
            a, b = ctl.report_failure(range(k_new, k_old))[0], jctl.report_failure(range(k_new, k_old))[0]
        assert OL.event_to_dict(a, drop_timings=True) == J_OL.event_to_dict(b, drop_timings=True)
    assert cep.migrated_edges_exact(1000, 4, 5) == J_cep.migrated_edges_exact(1000, 4, 5)
