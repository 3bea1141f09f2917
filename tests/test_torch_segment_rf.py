"""segment_rf: the plain version equals the JAX Pallas kernel (interpret mode)
and the numpy oracle; the wrapper dispatches by device without fallback. The
CUDA kernel itself is held against the plain version in test_torch_cuda.py."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ordering as J_ordering
from repro.core.graph import rmat_graph as J_rmat
from repro.kernels import ops as J_ops
from repro.kernels import segment_rf as J_segment_rf
from repro_torch.compat import PAD_ID
from repro_torch.kernels import ops, packed_sort, ref, segment_rf

CASES = [(4, 8), (16, 64), (7, 40), (33, 24)]  # the (c, w) cases of tests/test_kernels.py
EDGE_CASES = [(13, 1000), (9, 4097), (5, 1), (1, 3 * 4096 + 1)]


def _rows(c, w, seed):
    """Random rows as tests/test_kernels.py makes them: ids, 20% PAD, sorted."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 50, size=(c, w)).astype(np.int32)
    rows[rng.random((c, w)) < 0.2] = PAD_ID
    rows = np.sort(rows, axis=1)
    if c >= 3:
        rows[0] = PAD_ID  # an all-PAD row
        rows[1] = 7  # a single distinct id
        rows[2, w // 2 :] = PAD_ID
    return rows


def test_pad_id_matches_reference():
    assert PAD_ID == int(J_segment_rf.PAD_ID)


@pytest.mark.parametrize("c,w", CASES)
def test_plain_version_matches_pallas_kernel(c, w):
    rng = np.random.default_rng(c * 100 + w)
    rows = rng.integers(0, 50, size=(c, w)).astype(np.int32)
    rows[rng.random((c, w)) < 0.2] = PAD_ID
    rows = np.sort(rows, axis=1)
    want = np.asarray(J_segment_rf.segment_distinct_counts(jnp.asarray(rows)))
    got = segment_rf.segment_distinct_counts_torch(torch.from_numpy(rows))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,w", CASES + EDGE_CASES)
def test_plain_version_matches_numpy_oracle(c, w):
    rows = _rows(c, w, seed=c + w)
    got = segment_rf.segment_distinct_counts_torch(torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), ref.segment_distinct_counts_ref(rows, PAD_ID))


@pytest.mark.parametrize("c,w", CASES)
def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch(c, w):
    rows = torch.from_numpy(_rows(c, w, seed=1))
    before = segment_rf.launches
    got = segment_rf.segment_distinct_counts(rows)
    assert torch.equal(got, segment_rf.segment_distinct_counts_torch(rows))
    assert segment_rf.launches == before


@pytest.mark.parametrize(
    "bad,exc",
    [
        (torch.zeros((4, 8), dtype=torch.int64), TypeError),
        (torch.zeros(8, dtype=torch.int32), TypeError),
        (torch.zeros((8, 4), dtype=torch.int32).t(), ValueError),
        (torch.zeros((4, 8), dtype=torch.int32, device="meta"), ValueError),
    ],
    ids=["int64", "1-D", "non-contiguous", "meta-device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        segment_rf.segment_distinct_counts(bad)


@pytest.mark.parametrize("k", [4, 8, 16])
def test_replication_factor_kernel_matches_jax(k):
    jg = J_rmat(7, 6, seed=0)
    order = J_ordering.geo_order(jg, seed=0)
    s, d = jg.src[order], jg.dst[order]
    got = ops.replication_factor_kernel(s, d, k, jg.num_vertices, device="cpu")
    assert got == J_ops.replication_factor_kernel(s, d, k, jg.num_vertices)


def test_packed_rows_sort_and_pad():
    edges = torch.tensor([[[5, 1], [2, 9], [0, 0]], [[3, 3], [0, 0], [0, 0]]], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.float32)
    rows = ops.packed_rows(edges, mask)
    assert rows.tolist() == [[1, 2, 5, 9, PAD_ID, PAD_ID], [3, 3, PAD_ID, PAD_ID, PAD_ID, PAD_ID]]
    assert ops.chunk_vertex_counts_packed(edges, mask).tolist() == [4, 1]


def _pack_case(case):
    """``(edges, mask, num_vertices)`` of a ``packed_rows`` case: random ids
    below ``num_vertices``, about a fifth of the slots masked out."""
    rng = np.random.default_rng(len(case))
    k, e_max, nv = {"masked-middle": (3, 50, 1000), "all-pad-row": (4, 33, 77), "top-id": (2, 64, 2**22),
                    "nv-1": (3, 17, 1), "nv-max": (2, 40, 2**31 - 1), "k-1": (1, 300, 2**24),
                    "k-130": (130, 9, 513)}[case]
    edges = rng.integers(0, nv, size=(k, e_max, 2), dtype=np.int64).astype(np.int32)
    mask = (rng.random((k, e_max)) > 0.2).astype(np.float32)
    if case == "masked-middle":  # masked slots inside rows whose tails are valid
        mask[:, 10:20], mask[:, -5:] = 0.0, 1.0
    if case == "all-pad-row":  # a row with no valid slot, as the sharded pack's k_pad rows
        mask[1] = 0.0
    if case in ("top-id", "nv-max"):  # ids at num_vertices - 1
        edges[:, ::3, 1] = nv - 1
    return torch.from_numpy(edges), torch.from_numpy(mask), nv


@pytest.mark.parametrize("case", ["masked-middle", "all-pad-row", "top-id", "nv-1", "nv-max", "k-1", "k-130"])
def test_packed_rows_with_num_vertices_equals_the_none_path(case):
    edges, mask, nv = _pack_case(case)
    want = ops.packed_rows(edges, mask)
    got = ops.packed_rows(edges, mask, nv)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    valid = (mask > 0).sum(dim=1) * 2
    for r in range(edges.shape[0]):  # the valid ids ascending, PAD_ID after them
        ids = edges[r][mask[r] > 0].reshape(-1)
        assert torch.equal(got[r, : int(valid[r])], torch.sort(ids).values)
        assert bool((got[r, int(valid[r]) :] == PAD_ID).all())
    assert torch.equal(ops.chunk_vertex_counts_packed(edges, mask, nv), ops.chunk_vertex_counts_packed(edges, mask))


def test_packed_rows_equal_the_reference_rows():
    """The JAX package sorts its rows with ``jnp.sort``; the port's rows of the
    same chunks are the same ids, its padding to a multiple of 8 aside."""
    jg = J_rmat(7, 6, seed=0)
    order = J_ordering.geo_order(jg, seed=0)
    s, d = jg.src[order].astype(np.int32), jg.dst[order].astype(np.int32)
    k, n = 5, s.shape[0]
    bounds = np.linspace(0, n, k + 1).astype(int)
    e_max = int(np.diff(bounds).max())
    edges = np.zeros((k, e_max, 2), np.int32)
    mask = np.zeros((k, e_max), np.float32)
    ref_rows = np.full((k, 2 * e_max), PAD_ID, np.int32)
    for p in range(k):
        lo, hi = bounds[p], bounds[p + 1]
        edges[p, : hi - lo, 0], edges[p, : hi - lo, 1], mask[p, : hi - lo] = s[lo:hi], d[lo:hi], 1.0
        ref_rows[p, : 2 * (hi - lo)] = np.concatenate([s[lo:hi], d[lo:hi]])
    want = np.asarray(jnp.sort(jnp.asarray(ref_rows), axis=1))
    got = ops.packed_rows(torch.from_numpy(edges), torch.from_numpy(mask), jg.num_vertices)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("nv,bits,passes", [(None, 31, 4), (1, 1, 1), (2, 1, 1), (256, 8, 1), (257, 9, 2),
                                            (2**22, 22, 3), (2**24, 24, 3), (2**24 + 1, 25, 4), (2**26, 26, 4),
                                            (2**31 - 1, 31, 4), (np.int64(2**20), 20, 3)])
def test_digit_passes_follow_the_id_bound(nv, bits, passes):
    assert packed_sort.id_bits(nv) == bits and packed_sort.digit_passes(nv) == passes
    assert packed_sort.sort_bytes(10, 10, nv) == (8 + 8 * passes) * 10  # a row with no padding
    assert packed_sort.sort_bytes(10, 0, nv) == 16 * 10  # all padding: read twice, PAD_ID written


def test_wrapper_on_cpu_sorts_with_the_plain_version_without_a_launch():
    edges, mask, nv = _pack_case("masked-middle")
    before = (packed_sort.launches, packed_sort.passes)
    got = packed_sort.packed_sort(edges, mask, nv)
    assert torch.equal(got, packed_sort.packed_sort_torch(edges, mask))
    assert (packed_sort.launches, packed_sort.passes) == before


@pytest.mark.parametrize(
    "bad,exc",
    [("edges-int64", TypeError), ("edges-non-contiguous", ValueError), ("mask-shape", ValueError),
     ("mask-float64", TypeError), ("nv-0", ValueError), ("nv-2**31", ValueError), ("nv-negative", ValueError),
     ("nv-float", ValueError)],
)
def test_packed_sort_rejects_what_the_kernel_does_not_take(bad, exc):
    edges, mask, nv = _pack_case("masked-middle")
    if bad == "edges-int64":
        edges = edges.long()
    elif bad == "edges-non-contiguous":
        edges = edges.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "mask-shape":
        mask = mask[:, :-1].contiguous()
    elif bad == "mask-float64":
        mask = mask.double()
    else:
        nv = {"nv-0": 0, "nv-2**31": 2**31, "nv-negative": -5, "nv-float": 1000.0}[bad]
    with pytest.raises(exc):
        ops.packed_rows(edges, mask, nv)
