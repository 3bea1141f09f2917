"""edge_spmv and ops.chunked_spmv: the plain version equals the JAX Pallas
kernel (interpret mode) and the numpy oracle; the port's chunked_spmv equals
the JAX package's on GEO-ordered RMAT graphs; the vectorised packing is
byte-equal to the JAX package's per-edge loop. The CUDA kernel itself is held
against the plain version in test_torch_cuda.py.

Tolerances: the f32 sums run in another order than XLA's (the plain version
uses ``index_add_``, the JAX kernel one-hot matmuls), so results agree to
1e-5 per window and 1e-4 over whole graphs, as tests/test_kernels.py allows.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cep as J_cep
from repro.core import ordering as J_ordering
from repro.core.graph import rmat_graph as J_rmat
from repro.kernels import edge_spmv as J_edge_spmv
from repro.kernels import ops as J_ops
from repro_torch.kernels import edge_spmv, ops, ref

SHAPES = [(2, 16, 32), (5, 64, 128), (3, 128, 256)]  # the (c, we, wv) cases of tests/test_kernels.py


def _inputs(c, we, wv, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = wv + 1 if hi is None else hi
    src = rng.integers(lo, hi, size=(c, we)).astype(np.int32)
    dst = rng.integers(lo, hi, size=(c, we)).astype(np.int32)
    w = rng.standard_normal((c, we)).astype(np.float32)
    x = rng.standard_normal((c, wv)).astype(np.float32)
    return src, dst, w, x


def _plain(src, dst, w, x):
    return edge_spmv.spmv_blocked_torch(*(torch.from_numpy(a) for a in (src, dst, w, x))).numpy()


@pytest.mark.parametrize("c,we,wv", SHAPES)
def test_plain_version_matches_pallas_kernel(c, we, wv):
    src, dst, w, x = _inputs(c, we, wv, seed=c)  # ids in [0, wv]: wv is the padding
    want = np.asarray(J_edge_spmv.spmv_blocked(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(x)))
    np.testing.assert_allclose(_plain(src, dst, w, x), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "c,we,wv,lo,hi",
    [(2, 16, 32, 0, 33), (5, 64, 128, 0, 129), (3, 128, 256, 0, 257),
     (1, 1, 8, 0, 8), (4, 50, 16, -5, 40), (3, 200, 64, 64, 100)],
    ids=["test-shape-1", "test-shape-2", "test-shape-3", "one-edge", "ids-below-0-and-above-W_V", "all-padding"],
)
def test_plain_version_matches_numpy_oracle(c, we, wv, lo, hi):
    src, dst, w, x = _inputs(c, we, wv, seed=we, lo=lo, hi=hi)
    got = _plain(src, dst, w, x)
    np.testing.assert_allclose(got, ref.spmv_blocked_ref(src, dst, w, x), rtol=1e-5, atol=1e-5)
    if lo >= wv:
        assert not got.any()  # every id is padding: exactly 0


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    t = [torch.from_numpy(a) for a in _inputs(3, 40, 16, seed=3)]
    before = edge_spmv.launches
    assert torch.equal(edge_spmv.spmv_blocked(*t), edge_spmv.spmv_blocked_torch(*t))
    assert edge_spmv.launches == before


def _bad(kind):
    src, dst, w, x = (torch.from_numpy(a) for a in _inputs(2, 8, 4, seed=0))
    return {
        "int64-ids": (src.long(), dst, w, x),
        "f64-weights": (src, dst, w.double(), x),
        "1-D": (src[0], dst[0], w[0], x[0]),
        "shape-mismatch": (src, dst[:, :4].contiguous(), w, x),
        "chunk-mismatch": (src, dst, w, x[:1]),
        "non-contiguous": (src.t().contiguous().t(), dst, w, x),
        "meta-device": (src.to("meta"), dst.to("meta"), w.to("meta"), x.to("meta")),
    }[kind]


@pytest.mark.parametrize(
    "kind,exc",
    [("int64-ids", TypeError), ("f64-weights", TypeError), ("1-D", TypeError), ("shape-mismatch", ValueError),
     ("chunk-mismatch", ValueError), ("non-contiguous", ValueError), ("meta-device", ValueError)],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(kind, exc):
    with pytest.raises(exc):
        edge_spmv.spmv_blocked(*_bad(kind))


# ------------------------------------------------------------- chunked_spmv
@pytest.fixture(scope="module", params=[(6, 4), (7, 6)], ids=lambda p: f"rmat{p[0]}x{p[1]}")
def ordered(request):
    scale, ef = request.param
    g = J_rmat(scale, ef, seed=1)
    order = J_ordering.geo_order(g, seed=0)
    rng = np.random.default_rng(scale)
    x = rng.standard_normal(g.num_vertices).astype(np.float32)
    w = rng.random(g.num_edges).astype(np.float32) + 0.5
    return g.src[order], g.dst[order], w, x, g.num_vertices


def _windows(kind, src, bounds, v):
    """Window starts and size: full windows; 32-wide windows at each chunk's
    smallest src (edges leave them); 32-wide windows clipped at V, all to one
    length, which the JAX package's np.stack takes."""
    k = len(bounds) - 1
    if kind == "full":
        return [0] * k, v
    if kind == "narrow":
        return [int(np.clip(src[bounds[i]:bounds[i + 1]].min(), 0, v - 32)) for i in range(k)], 32
    return [v - 20] * k, 32


@pytest.mark.parametrize("kind", ["full", "narrow", "clipped"])
@pytest.mark.parametrize("k", [4, 16])
def test_chunked_spmv_matches_jax(ordered, kind, k):
    src, dst, w, x, v = ordered
    bounds = np.asarray(J_cep.chunk_bounds(src.shape[0], k))
    starts, size = _windows(kind, src, bounds, v)
    got = ops.chunked_spmv(src, dst, w, x, bounds, starts, size, device="cpu")
    want = J_ops.chunked_spmv(src, dst, w, x, bounds, starts, size)
    assert got.dtype == torch.float32 and got.shape == (v,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    oracle = np.zeros(v)
    np.add.at(oracle, dst, w.astype(np.float64) * x[src])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)
    if kind == "narrow":
        assert ops.pack_windows(src, dst, w, bounds, starts, size)[3].size > 0  # a real out-of-window pass


def test_chunked_spmv_clips_each_window_on_its_own(ordered):
    """Windows past the end of x clipped to different lengths: the JAX
    package's np.stack raises there; the port clips each window."""
    src, dst, w, x, v = ordered
    bounds = np.asarray(J_cep.chunk_bounds(src.shape[0], 4))
    starts, size = [0, v - 40, v - 10, v], 48
    with pytest.raises(ValueError):
        J_ops.chunked_spmv(src, dst, w, x, bounds, starts, size)
    got = ops.chunked_spmv(src, dst, w, x, bounds, starts, size, device="cpu")
    oracle = np.zeros(v)
    np.add.at(oracle, dst, w.astype(np.float64) * x[src])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)


def _pack_loop(src, dst, weights, chunk_bounds, window_starts, window_size):
    """A literal transcription of the JAX package's per-edge packing loop
    (repro/kernels/ops.py, chunked_spmv)."""
    c = len(window_starts)
    w_e = int(np.max(np.diff(chunk_bounds)))
    src_l = np.full((c, w_e), window_size, dtype=np.int32)
    dst_l = np.full((c, w_e), window_size, dtype=np.int32)
    wts = np.zeros((c, w_e), dtype=np.float32)
    fallback = []
    for ci in range(c):
        lo, hi = chunk_bounds[ci], chunk_bounds[ci + 1]
        ws = window_starts[ci]
        for j, e in enumerate(range(lo, hi)):
            sl, dl = src[e] - ws, dst[e] - ws
            if 0 <= sl < window_size and 0 <= dl < window_size:
                src_l[ci, j] = sl
                dst_l[ci, j] = dl
                wts[ci, j] = weights[e]
            else:
                fallback.append(e)
    return src_l, dst_l, wts, np.asarray(fallback, dtype=np.int64)


@pytest.mark.parametrize("kind", ["full", "narrow", "clipped"])
def test_vectorised_packing_is_byte_equal_to_the_loop(ordered, kind):
    src, dst, w, _, v = ordered
    bounds = np.asarray(J_cep.chunk_bounds(src.shape[0], 8))
    starts, size = _windows(kind, src, bounds, v)
    got = ops.pack_windows(src, dst, w, bounds, starts, size)
    want = _pack_loop(src, dst, w, bounds, starts, size)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "starts,size,bounds",
    [([-1, 0], 8, None), ([0, 999], 8, None), ([0, 0], 0, None), ([0, 0], 8, [0, 5])],
    ids=["negative-start", "start-past-V", "empty-window", "bounds-mismatch"],
)
def test_chunked_spmv_rejects_bad_windows(starts, size, bounds):
    src = np.array([0, 1, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 3, 0], dtype=np.int32)
    w = np.ones(4, dtype=np.float32)
    x = np.ones(10, dtype=np.float32)
    with pytest.raises(ValueError):
        ops.chunked_spmv(src, dst, w, x, [0, 2, 4] if bounds is None else bounds, starts, size, device="cpu")


# ------------------------------------------------------ packing on the device
def _window_cases(kind, src, bounds, v):
    """``_windows``' kinds, plus a window with no in-window edge (past every
    id of its chunk) and a window that starts past V (clipped to nothing)."""
    if kind in ("full", "narrow", "clipped"):
        return _windows(kind, src, bounds, v)
    starts, size = _windows("narrow", src, bounds, v)
    if kind == "empty-chunk":
        starts[1] = int(src[bounds[1]:bounds[2]].max()) + 1  # every edge of chunk 1 leaves its window
        return starts, size
    starts[-1] = v  # past-V: the last window holds no vertex
    return starts, size


@pytest.mark.parametrize("kind", ["full", "narrow", "clipped", "empty-chunk", "past-V"])
def test_device_packing_is_byte_equal_to_the_host_packing_and_the_loop(ordered, kind):
    src, dst, w, _, v = ordered
    bounds = np.asarray(J_cep.chunk_bounds(src.shape[0], 8))
    starts, size = _window_cases(kind, src, bounds, v)
    got = ops.pack_windows_device(src, dst, w, bounds, starts, size, device="cpu")
    host = ops.pack_windows(src, dst, w, bounds, starts, size)
    loop = _pack_loop(src, dst, w, bounds, starts, size)
    for a, b, c in zip(got, host, loop):
        a = a.numpy()
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
        assert a.tobytes() == b.tobytes() == c.tobytes()
    if kind == "empty-chunk":
        assert not (got[0][1] < size).any()  # chunk 1 is all padding
        assert np.isin(np.arange(bounds[1], bounds[2]), got[3].numpy()).all()


def test_device_packing_of_chunks_that_skip_edges():
    """Bounds that start past edge 0 and end before the last edge, with an
    empty chunk between: only the edges inside the bounds are packed."""
    rng = np.random.default_rng(3)
    src, dst = (rng.integers(0, 50, size=40).astype(np.int32) for _ in range(2))
    w = rng.random(40).astype(np.float32)
    bounds, starts, size = [3, 10, 10, 31], [0, 5, 20], 30
    got = ops.pack_windows_device(src, dst, w, bounds, starts, size, device="cpu")
    for a, b in zip(got, ops.pack_windows(src, dst, w, bounds, starts, size)):
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == b.tobytes()


def test_chunked_spmv_never_runs_the_host_packer(ordered, monkeypatch):
    src, dst, w, x, v = ordered
    bounds = np.asarray(J_cep.chunk_bounds(src.shape[0], 4))
    starts, size = _windows("narrow", src, bounds, v)
    want = ops.chunked_spmv(src, dst, w, x, bounds, starts, size, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("chunked_spmv called the numpy pack_windows")

    monkeypatch.setattr(ops, "pack_windows", refuse)
    got = ops.chunked_spmv(src, dst, w, x, bounds, starts, size, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("starts_of", ["all-one-start", "pairs", "mixed"])
def test_add_back_of_windows_that_share_a_start_matches_jax(ordered, starts_of):
    """Several chunks on one window start: their rows are summed before the
    one slice add of that start. Same result as the JAX package."""
    src, dst, w, x, v = ordered
    bounds = np.asarray(J_cep.chunk_bounds(src.shape[0], 6))
    size = v // 2
    starts = {"all-one-start": [v // 4] * 6, "pairs": [0, 0, 7, 7, v // 2, v // 2],
              "mixed": [3, 0, 3, v - size, 0, 3]}[starts_of]
    got = ops.chunked_spmv(src, dst, w, x, bounds, starts, size, device="cpu")
    want = J_ops.chunked_spmv(src, dst, w, x, bounds, starts, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    oracle = np.zeros(v)
    np.add.at(oracle, dst, w.astype(np.float64) * x[src])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)


def test_chunked_spmv_rejects_endpoints_outside_x():
    src = np.array([0, 1, 2, 10], dtype=np.int32)
    dst = np.array([1, 2, 3, 0], dtype=np.int32)
    with pytest.raises(ValueError):
        ops.chunked_spmv(src, dst, np.ones(4, np.float32), np.ones(10, np.float32), [0, 2, 4], [0, 0], 8,
                         device="cpu")
