"""The port on the GPU: the CUDA segment_rf kernel against its plain version,
and the main path on the card against the same path on the CPU.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.compat import PAD_ID
from repro_torch.core import metrics, ordering
from repro_torch.core.graph import rmat_graph
from repro_torch.elastic.rescale_exec import ElasticRescaler
from repro_torch.graphs import engine as E
from repro_torch.kernels import ops, ref, segment_rf

pytestmark = pytest.mark.cuda

SHAPES = [(4, 8), (16, 64), (7, 40), (33, 24), (13, 1000), (9, 4097), (5, 1), (1, 3 * 4096 + 1),
          (128, 240_000), (4, 7_500_000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the segment_rf kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ordered():
    g = rmat_graph(10, 8, seed=0)
    order = ordering.geo_order(g, seed=0)
    return g, g.src[order], g.dst[order]


def _rows(c, w, seed):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, 3 * w, size=(c, w)).astype(np.int32), axis=1)
    n_valid = rng.integers(0, w + 1, size=c)
    rows[np.arange(w)[None, :] >= n_valid[:, None]] = PAD_ID
    rows[0] = PAD_ID  # an all-PAD row
    if c > 1:
        rows[1] = 7  # a single distinct id
    return rows


@pytest.mark.parametrize("c,w", SHAPES)
def test_kernel_matches_plain_version(cuda, c, w):
    rows = _rows(c, w, seed=c + w)
    t = torch.from_numpy(rows).to(cuda)
    before = segment_rf.launches
    got = segment_rf.segment_distinct_counts(t)
    torch.cuda.synchronize()
    assert segment_rf.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, segment_rf.segment_distinct_counts_torch(t))
    if c * w <= 1 << 16:
        assert np.array_equal(got.cpu().numpy(), ref.segment_distinct_counts_ref(rows, PAD_ID))


@pytest.mark.parametrize("bad", [torch.int64, "non-contiguous"])
def test_kernel_wrapper_rejects_bad_input(cuda, bad):
    if bad == "non-contiguous":
        t = torch.zeros((8, 4), dtype=torch.int32, device=cuda).t()
        with pytest.raises(ValueError):
            segment_rf.segment_distinct_counts(t)
    else:
        with pytest.raises(TypeError):
            segment_rf.segment_distinct_counts(torch.zeros((4, 8), dtype=bad, device=cuda))


@pytest.mark.parametrize("k", [4, 16, 17])
def test_pack_on_cuda_equals_pack_on_cpu_and_oracle(cuda, ordered, k):
    g, s, d = ordered
    got = E.pack_ordered(s, d, g.num_vertices, k)  # device=None means CUDA
    want = E.pack_ordered(s, d, g.num_vertices, k, device="cpu")
    assert got.edges.device.type == "cuda"
    for name in ("edges", "mask", "degrees"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert got.replication_factor == metrics.replication_factor_ordered(s, d, k, g.num_vertices)
    assert got.mirrors == metrics.mirror_count_ordered(s, d, k, g.num_vertices)
    assert ops.replication_factor_kernel(s, d, k, g.num_vertices) == got.replication_factor


def test_rescale_on_cuda_rechecks_through_the_kernel(cuda, ordered):
    g, s, d = ordered
    data = E.pack_ordered(s, d, g.num_vertices, 8)
    before = segment_rf.launches
    new, stats = ElasticRescaler().rescale(data, 12, verify=True)
    assert segment_rf.launches == before + 1
    assert stats.oracle_checked and new.edges.device.type == "cuda"
    assert new.replication_factor == metrics.replication_factor_ordered(s, d, 12, g.num_vertices)


def test_apps_on_cuda_match_cpu(cuda, ordered):
    g, s, d = ordered
    gpu = E.pack_ordered(s, d, g.num_vertices, 8)
    cpu = E.pack_ordered(s, d, g.num_vertices, 8, device="cpu")
    # CUDA scatter-add uses atomics, so the f32 sums run in another order.
    torch.testing.assert_close(E.pagerank(gpu).cpu(), E.pagerank(cpu), rtol=1e-5, atol=1e-7)
    for app in (E.sssp, E.wcc):
        (x_gpu, it_gpu), (x_cpu, it_cpu) = app(gpu), app(cpu)
        assert it_gpu == it_cpu and torch.equal(x_gpu.cpu(), x_cpu)
