"""flash_attention and decode_attention: the port's plain versions (what the
wrappers run on the CPU) equal the JAX Pallas kernels (interpret mode) and the
numpy oracles on the same inputs. The CUDA kernels themselves are held against
the plain versions in test_torch_cuda.py.

Inputs are made with numpy and rounded to bf16 the same way in both
frameworks. Tolerances are tests/test_kernels.py's: 2e-5 in f32 (the sums run
in another order than XLA's), 2e-2 where the output is bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as J_dec
from repro.kernels import flash_attention as J_fa
from repro.kernels import ops as J_ops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5), "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}
FLASH_CASES = [  # tests/test_kernels.py's (b, h, s, d, window, softcap), then D = 256 (gemma2-9b's head_dim)
    (1, 2, 128, 64, None, None),
    (2, 1, 256, 32, None, None),
    (1, 2, 256, 64, 128, None),
    (1, 1, 128, 64, None, 30.0),
    (2, 2, 384, 128, 256, 50.0),
    (1, 1, 256, 256, 64, 50.0),
]


def _both(shape, dtype, seed):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    _, jdt, tdt, _ = DTYPES[dtype]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32), np.float32)


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d,window,softcap", FLASH_CASES)
def test_flash_matches_pallas_kernel(b, h, s, d, window, softcap, dtype):
    (jq, q), (jk, k), (jv, v) = (_both((b, h, s, d), dtype, seed) for seed in (1, 2, 3))
    got = ops.flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
    want = J_fa.flash_attention(jq, jk, jv, causal=True, window=window, softcap=softcap, block_q=128, block_kv=128)
    tol = DTYPES[dtype][3]
    assert got.dtype == DTYPES[dtype][2] and got.shape == (b, h, s, d)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)
    oracle = ref.attention_ref(_np32(q), _np32(k), _np32(v), causal=True, window=window, softcap=softcap)
    np.testing.assert_allclose(_np32(got), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_noncausal_matches_pallas_kernel(window):
    (jq, q), (jk, k), (jv, v) = (_both((1, 1, 128, 32), "f32", seed) for seed in (4, 5, 6))
    got = fa.flash_attention(q, k, v, causal=False, window=window)
    want = J_fa.flash_attention(jq, jk, jv, causal=False, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "s,jax_block,window,softcap",
    [(192, 64, None, None), (100, 100, 7, None), (96, 32, 40, 30.0)],
)
def test_flash_takes_any_sequence_length(s, jax_block, window, softcap):
    """The port has no block sizes: a length that is not a multiple of 128
    (where JAX needs blocks that divide it) gives JAX's result."""
    (jq, q), (jk, k), (jv, v) = (_both((1, 2, s, 32), "f32", seed) for seed in (7, 8, 9))
    got = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    want = J_fa.flash_attention(jq, jk, jv, window=window, softcap=softcap, block_q=jax_block, block_kv=jax_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    oracle = ref.attention_ref(q.numpy(), k.numpy(), v.numpy(), causal=True, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


def test_flash_on_cpu_does_not_launch():
    _, q = _both((1, 1, 128, 32), "f32", 8)
    before = fa.launches
    torch.testing.assert_close(fa.flash_attention(q, q, q), fa.flash_attention_torch(q, q, q))
    assert fa.launches == before


@pytest.mark.parametrize(
    "kw,shapes,exc",
    [
        (dict(), ((1, 1, 128, 32), (1, 1, 64, 32), (1, 1, 128, 32)), ValueError),  # JAX asserts k.shape == q.shape
        (dict(window=0), ((1, 1, 128, 32),) * 3, ValueError),
        (dict(interpret=True), ((1, 1, 128, 32),) * 3, TypeError),  # no interpret switch in the port
    ],
    ids=["kv-shape", "window-0", "interpret"],
)
def test_flash_rejects_what_jax_asserts(kw, shapes, exc):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(exc):
        ops.flash_attention(q, k, v, **kw)


def test_flash_jax_asserts_where_the_port_raises():
    q, k = jnp.zeros((1, 1, 128, 32)), jnp.zeros((1, 1, 64, 32))
    with pytest.raises(AssertionError):
        J_fa.flash_attention(q, k, q)


# ---------------------------------------------------------- decode attention
DECODE_CASES = [(2, 4, 512, 64, 128), (1, 1, 1024, 32, 256), (3, 8, 256, 128, 256)]  # tests/test_kernels.py


def _decode_inputs(bh, gq, s, d, seed, kv_dtype="f32", cache=None):
    rng = np.random.default_rng(seed)
    jq, q = _both((bh, gq, d), "f32", seed + 1)
    (jk, k), (jv, v) = _both((bh, s, d), kv_dtype, seed + 2), _both((bh, s, d), kv_dtype, seed + 3)
    cl = rng.integers(1, s + 1, size=bh).astype(np.int32) if cache is None else np.asarray(cache, np.int32)
    return (jq, jk, jv, jnp.asarray(cl)), (q, k, v, torch.from_numpy(cl))


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("bh,gq,s,d,block_s", DECODE_CASES)
def test_decode_matches_pallas_kernel(bh, gq, s, d, block_s, softcap):
    jx, tx = _decode_inputs(bh, gq, s, d, seed=bh * 10 + gq)
    got = ops.decode_attention(*tx, block_s=block_s, softcap=softcap)
    want = J_ops.decode_attention(*jx, block_s=block_s, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (bh, gq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    oracle = ref.decode_attention_ref(*(_np32(a) for a in tx[:3]), tx[3].numpy(), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


def test_decode_row_with_empty_cache_is_the_mean_of_v():
    """cache_len = 0 masks every key with -1e30, not -inf: each tile gives
    m = -1e30, l = block_s and o = its mean of v, and the merge returns the
    mean of all of v, as the JAX kernel does."""
    jx, tx = _decode_inputs(3, 4, 512, 64, seed=5, cache=[0, 200, 512])
    got = dec.decode_attention(*tx, block_s=128)
    want = J_dec.decode_attention(*jx, block_s=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(tx[2][0].numpy().mean(0), (4, 64)), rtol=1e-5, atol=1e-6)
    o, m, l = dec.decode_attention_partials(*tx, block_s=128)
    assert bool((m[0] == np.float32(-1e30)).all()) and bool((l[0] == 128).all())


def test_decode_bf16_cache_matches_pallas_kernel():
    jx, tx = _decode_inputs(2, 4, 512, 128, seed=6, kv_dtype="bf16", cache=[77, 512])
    got = dec.decode_attention(*tx, block_s=256)
    want = J_dec.decode_attention(*jx, block_s=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bh,gq,s,d,block_s", DECODE_CASES)
def test_decode_partials_match_pallas_kernel(bh, gq, s, d, block_s):
    jx, tx = _decode_inputs(bh, gq, s, d, seed=11, cache=[s // 3 + 1] + [s] * (bh - 1))
    got = dec.decode_attention_partials(*tx, block_s=block_s)
    want = J_dec.decode_attention_partials(*jx, block_s=block_s)
    nb = s // block_s
    for name, g, w, shape in zip("oml", got, want, [(bh, nb, gq, d), (bh, nb, gq, 1), (bh, nb, gq, 1)]):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


def test_merge_is_associative_across_devices():
    """As tests/test_kernels.py: merging all tiles at once equals merging two
    groups of four and then the groups, each re-entering as (o, lse, 1)."""
    _, (q, k, v, _) = _decode_inputs(2, 2, 1024, 64, seed=7)
    cache_len = torch.full((2,), 1024, dtype=torch.int32)
    o, m, l = dec.decode_attention_partials(q, k, v, cache_len, block_s=128)
    all_at_once, _ = dec.merge_partials(o, m, l, axis=1)
    g1, lse1 = dec.merge_partials(o[:, :4], m[:, :4], l[:, :4], axis=1)
    g2, lse2 = dec.merge_partials(o[:, 4:], m[:, 4:], l[:, 4:], axis=1)
    stacked_m = torch.stack([lse1, lse2], dim=1)
    grouped, _ = dec.merge_partials(torch.stack([g1, g2], dim=1), stacked_m, torch.ones_like(stacked_m), axis=1)
    torch.testing.assert_close(grouped, all_at_once, rtol=1e-5, atol=1e-5)
    j_out, j_lse = J_dec.merge_partials(*(jnp.asarray(t.numpy()) for t in (o, m, l)), axis=1)
    np.testing.assert_allclose(all_at_once.numpy(), np.asarray(j_out), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dec.merge_partials(o, m, l)[1].numpy(), np.asarray(j_lse), rtol=1e-6, atol=1e-6)


def test_decode_on_cpu_does_not_launch():
    _, tx = _decode_inputs(1, 2, 256, 32, seed=9)
    before = dec.launches
    dec.decode_attention(*tx, block_s=128)
    assert dec.launches == before


@pytest.mark.parametrize(
    "kind,exc",
    [("s-not-multiple-of-block_s", ValueError), ("cache_len-int64", TypeError), ("kv-shape", ValueError),
     ("interpret", TypeError)],
)
def test_decode_rejects_what_jax_asserts(kind, exc):
    q, k, cl = torch.zeros(2, 4, 32), torch.zeros(2, 384, 32), torch.ones(2, dtype=torch.int32)
    args, kw = {
        "s-not-multiple-of-block_s": ((q, k, k, cl), dict(block_s=256)),  # JAX asserts s % block_s == 0
        "cache_len-int64": ((q, k, k, cl.long()), {}),
        "kv-shape": ((q, k, k[:, :, :16], cl), {}),
        "interpret": ((q, k, k, cl), dict(interpret=True)),  # no interpret switch in the port
    }[kind]
    with pytest.raises(exc):
        ops.decode_attention(*args, **kw)
