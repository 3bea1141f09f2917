"""The port's ElasticRescaler on packs handed over from the JAX package: the
executed k_old → k_new result is byte-equal to the JAX package's executed
result and to its fresh pack at k_new, with equal RescaleStats."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as J_baselines
from repro.core import cep as J_cep
from repro.core import ordering as J_ordering
from repro.core.graph import rmat_graph as J_rmat
from repro.elastic.rescale_exec import ElasticRescaler as J_ElasticRescaler
from repro.graphs import engine as J_E
from repro_torch.core import cep
from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler, plan_segments
from repro_torch.graphs import engine as E
from repro_torch.kernels import segment_rf
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT

PAIRS = [(8, 12), (12, 8), (4, 5), (5, 4), (16, 20), (20, 16), (3, 7), (2, 3)]  # as tests/test_rescale_exec.py
TIMINGS = ("elapsed_s", "recheck_s")


@pytest.fixture(scope="module")
def ordered():
    jg = J_rmat(8, 6, seed=0)
    order = J_ordering.geo_order(jg, seed=0)
    return jg, jg.src[order], jg.dst[order]


def _port_of(jdata):
    return E.engine_data_from_arrays(
        np.asarray(jdata.edges), np.asarray(jdata.mask), np.asarray(jdata.degrees),
        num_vertices=jdata.num_vertices, k=jdata.k, mirrors=jdata.mirrors,
        replication_factor=jdata.replication_factor, num_edges=jdata.num_edges, device="cpu",
    )


def _assert_pack_equals(got, want):
    for name in ("edges", "mask", "degrees"):
        assert np.array_equal(getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))), name
    assert (got.k, got.num_edges, got.num_vertices) == (want.k, want.num_edges, want.num_vertices)
    assert got.mirrors == want.mirrors
    assert got.replication_factor == want.replication_factor


def _stats_without_timings(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats) if f.name not in TIMINGS}


@pytest.mark.parametrize("k_old,k_new", PAIRS)
def test_executed_equals_jax_executed_and_fresh_pack(ordered, k_old, k_new):
    jg, src, dst = ordered
    plan = J_cep.scale_plan(jg.num_edges, k_old, k_new)
    jax_new, jax_stats = J_ElasticRescaler().execute(
        J_E.pack_ordered(src, dst, jg.num_vertices, k_old), plan, verify=True
    )
    data = _port_of(J_E.pack_ordered(src, dst, jg.num_vertices, k_old))
    new, stats = ElasticRescaler().execute(data, cep.scale_plan(jg.num_edges, k_old, k_new), verify=True)
    _assert_pack_equals(new, jax_new)
    _assert_pack_equals(new, J_E.pack_ordered(src, dst, jg.num_vertices, k_new))
    assert _stats_without_timings(stats) == _stats_without_timings(jax_stats)
    assert stats.oracle_checked and stats.elapsed_s > 0
    assert stats.migrated_bytes == plan.migrated_bytes(EDGE_BYTES)
    assert stats.copy_ops == len(plan_segments(plan)) <= k_old + k_new


@pytest.mark.parametrize("k_old,k_new", PAIRS)
def test_recheck_off_matches_jax_and_skips_the_kernel(ordered, k_old, k_new):
    jg, src, dst = ordered
    jax_new, jax_stats = J_ElasticRescaler().rescale(
        J_E.pack_ordered(src, dst, jg.num_vertices, k_old), k_new, recheck=False
    )
    data = _port_of(J_E.pack_ordered(src, dst, jg.num_vertices, k_old))
    new, stats = ElasticRescaler().rescale(data, k_new, recheck=False)
    assert np.array_equal(new.edges.numpy(), np.asarray(jax_new.edges))
    assert np.array_equal(new.mask.numpy(), np.asarray(jax_new.mask))
    assert new.mirrors == -1 and np.isnan(new.replication_factor)
    assert _stats_without_timings(stats) == _stats_without_timings(jax_stats)


def test_roundtrip_bit_identical_and_input_stays_valid(ordered):
    jg, src, dst = ordered
    d8 = _port_of(J_E.pack_ordered(src, dst, jg.num_vertices, 8))
    edges_before = d8.edges.clone()
    r = ElasticRescaler()
    d12, _ = r.rescale(d8, 12, verify=True)
    back, _ = r.rescale(d12, 8, verify=True)
    assert torch.equal(back.edges, d8.edges) and torch.equal(back.mask, d8.mask)
    assert back.mirrors == d8.mirrors and back.replication_factor == d8.replication_factor
    assert torch.equal(d8.edges, edges_before)  # no donation: the input is still readable
    assert back.edges.data_ptr() != d8.edges.data_ptr()


def test_degenerate_more_partitions_than_edges():
    jg = J_rmat(4, 1, seed=2)
    src, dst = jg.src, jg.dst
    k_new = jg.num_edges + 5
    data = E.pack_ordered(src, dst, jg.num_vertices, 2, device="cpu")
    new, _ = ElasticRescaler().rescale(data, k_new, verify=True)
    _assert_pack_equals(new, J_E.pack_ordered(src, dst, jg.num_vertices, k_new))


def test_noop_plan_returns_the_input(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 6, device="cpu")
    same, stats = ElasticRescaler().rescale(data, 6)
    assert same is data and stats.copy_ops == 0 and stats.stay_edges == jg.num_edges


def test_rejects_non_cep_layouts_and_wrong_plans(ordered):
    jg, src, dst = ordered
    part = J_baselines.hash_1d(jg, 8)
    hashed = E.build_engine_data(jg, part, 8, device="cpu")
    r = ElasticRescaler()
    with pytest.raises(ValueError, match="not CEP-chunked"):
        r.rescale(hashed, 12)
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    with pytest.raises(ValueError, match="k_old"):
        r.execute(data, cep.scale_plan(jg.num_edges, 4, 8))
    with pytest.raises(ValueError, match=r"\|E\|"):
        r.execute(data, cep.scale_plan(jg.num_edges + 1, 8, 12))


def test_program_cache_hits_and_lru_bound(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    r = ElasticRescaler(program_cache_size=2)
    for k_new in (12, 12, 9, 10):
        r.rescale(data, k_new, recheck=False)
    c = r._programs.counters["migrate"]
    assert (c["hits"], c["misses"], c["evictions"]) == (1, 3, 1)
    assert len(r._programs) == 2 == r.program_cache_size
    with pytest.raises(ValueError):
        ElasticRescaler(program_cache_size=0)


def test_trace_span_and_metrics_recorded(ordered):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    tracer, registry = OT.Tracer(capacity=16), OM.MetricsRegistry()
    r = ElasticRescaler(tracer=tracer, metrics_registry=registry)
    _, stats = r.rescale(data, 12, recheck=False)
    (rec,) = tracer.spans()
    assert (rec.name, rec.phase) == ("rescale.migrate", "rescale") and rec.duration_s > 0
    snap = registry.snapshot()
    assert snap["rescale.migrated_bytes"] == stats.migrated_bytes
    assert snap["rescale.migrate_s.count"] == 1.0
    assert snap["rescale.cross_device_bytes"] == 0.0
    assert ElasticRescaler().tracer is OT.get_tracer() and not OT.get_tracer().enabled


def test_recheck_measures_counts_through_the_segment_rf_wrapper(ordered, monkeypatch):
    jg, src, dst = ordered
    data = E.pack_ordered(src, dst, jg.num_vertices, 8, device="cpu")
    calls = []
    plain = segment_rf.segment_distinct_counts
    monkeypatch.setattr(segment_rf, "segment_distinct_counts", lambda rows: calls.append(rows.shape) or plain(rows))
    ElasticRescaler().rescale(data, 12)
    ElasticRescaler().rescale(data, 12, recheck=False)
    assert len(calls) == 1 and calls[0][0] == 12
