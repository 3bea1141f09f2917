"""The port's host core (numpy copies) is byte-equal to the JAX package's:
GEO permutations, CEP bounds / id2p / scale plans, RF and mirrors, baselines,
theory, and the partition placement math."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import numpy as np
import pytest

from repro.core import baselines as J_baselines
from repro.core import cep as J_cep
from repro.core import metrics as J_metrics
from repro.core import ordering as J_ordering
from repro.core import theory as J_theory
from repro.core.graph import rmat_graph as J_rmat
from repro.launch import sharding as J_SH
from repro_torch.core import baselines, cep, metrics, ordering, theory
from repro_torch.core.graph import rmat_graph
from repro_torch.launch import sharding as SH

GRAPHS = [(8, 6), (6, 4)]  # (scale, edge_factor)


@pytest.fixture(scope="module", params=GRAPHS, ids=lambda p: f"rmat{p[0]}x{p[1]}")
def graphs(request):
    scale, ef = request.param
    return rmat_graph(scale, ef, seed=0), J_rmat(scale, ef, seed=0)


def test_rmat_graph_equal(graphs):
    g, jg = graphs
    assert g.num_vertices == jg.num_vertices
    for name in ("src", "dst", "indptr", "nbr", "eid"):
        a, b = getattr(g, name), getattr(jg, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("k_min,k_max", [(4, 128), (2, 16)])
def test_geo_order_permutation_equal(graphs, k_min, k_max):
    g, jg = graphs
    got = ordering.geo_order(g, k_min=k_min, k_max=k_max, seed=0)
    want = J_ordering.geo_order(jg, k_min=k_min, k_max=k_max, seed=0)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("num_edges", [0, 1, 7, 1042, 10**6 + 3])
@pytest.mark.parametrize("k", [1, 3, 8, 17, 128])
def test_chunk_bounds_and_id2p_equal(num_edges, k):
    b = cep.chunk_bounds(num_edges, k)
    jb = J_cep.chunk_bounds(num_edges, k)
    assert b.dtype == jb.dtype and np.array_equal(b, jb)
    ids = np.unique(np.linspace(0, max(num_edges - 1, 0), num=min(num_edges, 257)).astype(np.int64))
    assert np.array_equal(cep.id2p(num_edges, k, ids), J_cep.id2p(num_edges, k, ids))


@pytest.mark.parametrize("k_old,k_new", [(8, 12), (12, 8), (4, 5), (16, 17), (3, 7), (128, 4)])
def test_scale_plan_equal(k_old, k_new):
    n = 9973
    plan, jplan = cep.scale_plan(n, k_old, k_new), J_cep.scale_plan(n, k_old, k_new)
    assert plan.moves == jplan.moves and plan.stay == jplan.stay
    assert plan.migrated_edges == jplan.migrated_edges
    assert cep.migration_cost_theorem2(n, k_old, 3) == J_cep.migration_cost_theorem2(n, k_old, 3)


@pytest.mark.parametrize("k", [4, 8, 16, 64])
def test_rf_and_mirrors_equal(graphs, k):
    g, jg = graphs
    order = J_ordering.geo_order(jg, seed=0)
    s, d = g.src[order], g.dst[order]
    assert np.array_equal(
        metrics.chunk_vertex_counts_ordered(s, d, k), J_metrics.chunk_vertex_counts_ordered(s, d, k)
    )
    assert metrics.replication_factor_ordered(s, d, k, g.num_vertices) == J_metrics.replication_factor_ordered(
        s, d, k, g.num_vertices
    )
    assert metrics.mirror_count_ordered(s, d, k, g.num_vertices) == J_metrics.mirror_count_ordered(
        s, d, k, g.num_vertices
    )


@pytest.mark.parametrize("method", ["hash_1d", "hash_2d", "dbh", "bvc_partition", "hdrf"])
def test_baseline_partitions_equal(graphs, method):
    g, jg = graphs
    k = 8
    part = getattr(baselines, method)(g, k)
    assert np.array_equal(part, getattr(J_baselines, method)(jg, k))
    assert metrics.replication_factor(g.src, g.dst, part, k, g.num_vertices) == J_metrics.replication_factor(
        g.src, g.dst, part, k, g.num_vertices
    )


def test_theory_table_equal():
    assert theory.table2(k=64, num_vertices=10**5) == J_theory.table2(k=64, num_vertices=10**5)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 5, 8, 17])
def test_partition_placement_equal(g, k):
    assert SH.GRAPH_AXIS == J_SH.GRAPH_AXIS
    assert SH.padded_partition_count(k, g) == J_SH.padded_partition_count(k, g)
    for p in range(k):
        assert SH.partition_device(p, g) == J_SH.partition_device(p, g)
        assert SH.partition_row(p, k, g) == J_SH.partition_row(p, k, g)
    for r in range(SH.padded_partition_count(k, g)):
        assert SH.row_partition(r, k, g) == J_SH.row_partition(r, k, g)


def test_graph_axis_size_is_the_world_size():
    assert SH.graph_axis_size() == 1 == J_SH.graph_axis_size(None)
    assert SH.graph_axis_size(4) == 4
    with pytest.raises(ValueError):
        SH.graph_axis_size(0)
