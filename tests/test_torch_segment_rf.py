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
from repro_torch.kernels import ops, ref, segment_rf

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
