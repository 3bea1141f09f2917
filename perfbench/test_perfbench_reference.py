"""The yardstick on the CPU: the generator, the frozen CEP arithmetic and the
plain reference against graphs built by hand."""
import hashlib

import numpy as np
import pytest
import torch

from perfbench import cep, reference
from perfbench.spec import load_module

graph500 = load_module("generators", "graph500")
PARAMS = {"scale": 10, "edge_factor": 16, "initiator": [0.57, 0.19, 0.19, 0.05], "instance_seed": 2**31 + 77}
CPU = torch.device("cpu")


def _edges(pairs):
    src = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
    dst = torch.tensor([b for _, b in pairs], dtype=torch.int32)
    return src, dst


# ------------------------------------------------------------------ generator
def test_generator_is_a_function_of_the_instance_seed():
    a = graph500.generate(PARAMS, CPU)
    b = graph500.generate(PARAMS, CPU)
    c = graph500.generate({**PARAMS, "instance_seed": 2**31 + 78}, CPU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and np.array_equal(a[3], b[3])
    assert not (a[0].shape == c[0].shape and torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]))


def test_generator_gives_an_ordered_simple_undirected_graph():
    src, dst, n, present = graph500.generate(PARAMS, CPU)
    s, d = src.long(), dst.long()
    assert n == 1024 and src.dtype == dst.dtype == torch.int32
    assert bool((s < d).all())  # no self-loop, lower endpoint first
    key = s * n + d
    assert bool((key[1:] > key[:-1]).all())  # sorted by (lower, higher), no duplicate
    assert 0.5 * 16 * n < src.numel() <= 16 * n
    assert np.array_equal(present, torch.unique(torch.cat([s, d])).numpy())


@pytest.mark.parametrize("initiator, edges", [([1.0, 0.0, 0.0, 0.0], 0), ([0.0, 1.0, 0.0, 0.0], 1)])
def test_generator_follows_the_initiator(initiator, edges):
    # All in quadrant A: every edge is (label 0, label 0), a self-loop. All
    # in B: every edge joins labels 0 and 2^scale - 1: one edge once deduplicated.
    src, _, _, _ = graph500.generate({**PARAMS, "initiator": initiator}, CPU)
    assert src.numel() == edges


def test_generator_refuses_an_initiator_that_does_not_sum_to_one():
    with pytest.raises(ValueError):
        graph500.generate({**PARAMS, "initiator": [0.5, 0.2, 0.2, 0.2]}, CPU)


def _digest(src, dst, present) -> str:
    h = hashlib.sha256()
    for a in (src.numpy(), dst.numpy(), present):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# The generator's graphs, taken on the CPU and pinned: a change to how it
# draws or builds them changes every cell's instance, which may not change.
@pytest.mark.parametrize("scale, seed, edges, present, digest", [
    (10, 2**31 + 77, 10_498, 888, "be9e58ea27e236830cc0607a70025d89690d5d9e50a55492b29d1ac952b1f864"),
    (14, 20261024, 212_983, 12_469, "f44f10f20a972ceb6c6146aa96c8f50cd91ff2a2a63f1b3d25f9f240ec20d12a"),
])
def test_generator_gives_the_graphs_of_its_first_version(scale, seed, edges, present, digest):
    src, dst, n, got_present = graph500.generate({**PARAMS, "scale": scale, "instance_seed": seed}, CPU)
    assert (src.numel(), got_present.shape[0], n) == (edges, present, 1 << scale)
    assert src.dtype == dst.dtype == torch.int32 and got_present.dtype == np.int64
    assert _digest(src, dst, got_present) == digest


# ------------------------------------------------------------------ CEP copy
@pytest.mark.parametrize("n, k", [(5, 2), (17, 4), (1000, 128), (100, 100), (15_701_711, 17)])
def test_cep_chunks_cover_the_list_and_agree_with_chunk_of(n, k):
    b = cep.chunk_bounds(n, k)
    sizes = np.diff(b)
    assert b[0] == 0 and b[-1] == n and sizes.max() - sizes.min() <= 1
    assert cep.chunk_max(n, k) == sizes.max()
    pos = torch.arange(0, n, max(1, n // 5000))
    want = np.searchsorted(b, pos.numpy(), side="right") - 1
    assert np.array_equal(cep.chunk_of(pos, n, k).numpy(), want)


# ------------------------------------------------------------------ reference
def test_pack_by_hand():
    src, dst = _edges([(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)])
    edges, mask = reference.pack(src, dst, 2)  # chunks [0, 2) and [2, 5)
    assert edges.tolist() == [[[0, 1], [1, 2], [0, 0]], [[2, 3], [3, 4], [0, 4]]]
    assert mask.tolist() == [[1, 1, 0], [1, 1, 1]]


def test_slots_wrong_counts_each_differing_slot_and_all_on_a_shape_change():
    src, dst = _edges([(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)])
    edges, mask = reference.pack(src, dst, 2)
    assert reference.slots_wrong(edges, mask, edges.clone(), mask.clone()) == 0
    bad = edges.clone()
    bad[1, 2, 1] = 7
    bad_mask = mask.clone()
    bad_mask[0, 2] = 1.0
    assert reference.slots_wrong(bad, bad_mask, edges, mask) == 2
    other_edges, other_mask = reference.pack(src, dst, 3)
    assert reference.slots_wrong(other_edges, other_mask, edges, mask) == max(other_mask.numel(), mask.numel())


def test_mirrors_by_hand():
    # A path 0-1-2-3: at k = 2 the chunks {01} and {12, 23} share vertex 1;
    # at k = 3 every edge is a chunk and vertices 1 and 2 are mirrored once each.
    src, dst = _edges([(0, 1), (1, 2), (2, 3)])
    assert reference.mirrors(src, dst, [1, 2, 3]) == {1: 0, 2: 1, 3: 2}


def _mirrors_by_brute_force(src, dst, k):
    """Σ_p |V(E_p)| − |V(E)|, each chunk's distinct vertices counted as a set."""
    b = cep.chunk_bounds(src.numel(), k)
    s, d = src.tolist(), dst.tolist()
    chunks = sum(len(set(s[b[p]:b[p + 1]]) | set(d[b[p]:b[p + 1]])) for p in range(k))
    return chunks - len(set(s) | set(d))


_SMALL = graph500.generate({**PARAMS, "scale": 7}, CPU)[:2]  # 925 edges, the highest degree 86


@pytest.mark.parametrize("n, k", [(n, k) for n in (2, 37, 925) for k in (1, 2, 3, 7, 64, 128) if k <= n])
@pytest.mark.parametrize("block", [1, 5, 64, 1 << 27])  # all but the last below the highest degree
def test_mirrors_in_blocks_equal_a_count_of_distinct_vertices_per_chunk(n, k, block, monkeypatch):
    # The first n edges of the scale-7 graph; most k leave an uneven last chunk.
    src, dst = _SMALL[0][:n], _SMALL[1][:n]
    assert n < 925 or int(torch.bincount(torch.cat([src, dst]).long()).max()) > 64
    monkeypatch.setattr(reference, "MIRROR_BLOCK", block)
    assert reference.mirrors(src, dst, [k]) == {k: _mirrors_by_brute_force(src, dst, k)}


def test_mirrors_answer_every_k_asked_for_at_once(monkeypatch):
    src, dst = _SMALL
    ks = [128, 4, 17, 4, 5]
    monkeypatch.setattr(reference, "MIRROR_BLOCK", 100)
    got = reference.mirrors(src, dst, ks)
    assert got == {k: _mirrors_by_brute_force(src, dst, k) for k in sorted(set(ks))}
    assert reference.mirrors(src[:0], dst[:0], [3]) == {3: 0}


def test_sssp_by_hand():
    # 0-1-2-3 and 1-4; vertex 5 isolated; vertex 6 in another component.
    src, dst = _edges([(0, 1), (1, 2), (2, 3), (1, 4), (6, 7)])
    dist, sweeps = reference.sssp(src, dst, 8, 0, 64)
    assert dist.tolist() == [0, 1, 2, 3, 2, 1e9, 1e9, 1e9] and sweeps == 4  # eccentricity 3, one sweep more
    dist, sweeps = reference.sssp(src, dst, 8, 0, 2)  # cut at two sweeps: two hops known
    assert dist.tolist() == [0, 1, 2, 1e9, 2, 1e9, 1e9, 1e9] and sweeps == 2


def test_wcc_by_hand():
    src, dst = _edges([(3, 4), (4, 5), (0, 6), (2, 6)])
    labels, sweeps = reference.wcc(src, dst, 7, 64)
    assert labels.tolist() == [0, 1, 0, 3, 3, 3, 0]
    assert sweeps == 3  # vertex 5 is two hops from 3, vertex 2 two from 0: two sweeps change, one confirms


def test_pagerank_matches_a_dense_power_iteration():
    src, dst = _edges([(0, 1), (1, 2), (2, 0), (2, 3), (4, 5)])
    v, d = 7, 0.85  # vertex 6 has no edge
    a = np.zeros((v, v))
    for s, t in zip(src.tolist(), dst.tolist()):
        a[s, t] = a[t, s] = 1
    deg = a.sum(1)
    x = np.full(v, 1 / v)
    for _ in range(20):
        x = (1 - d) / v + d * (a.T @ (x / np.maximum(deg, 1)) + x[deg == 0].sum() / v)
    got = reference.pagerank(src, dst, v, 20, d)
    assert np.allclose(got.numpy(), x, rtol=1e-12, atol=0) and abs(got.sum().item() - 1) < 1e-12


def test_lower_precision_changes_the_answers():
    src, dst, v, _ = graph500.generate(PARAMS, CPU)
    exact = reference.pagerank(src, dst, v, 20, 0.85)
    low = reference.pagerank(src, dst, v, 20, 0.85, dtype=torch.bfloat16)
    assert float(((low.double() - exact).abs() / exact).max()) > 1e-3
    labels, _ = reference.wcc(src, dst, v, 64)
    low_labels, _ = reference.wcc(src, dst, v, 64, dtype=torch.bfloat16)
    assert not torch.equal(low_labels.double(), labels.double())
