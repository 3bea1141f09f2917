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


# ------------------------------------- the tensor-core kernel's arithmetic
# csrc/flash_attention.cu runs bf16 inputs on the tensor cores, which cannot
# run here. This emulation repeats its arithmetic on the CPU: 128-row query
# blocks of two 64-row warpgroups, each over the 64-key tiles from the
# block's window start that hold a key one of its rows sees; S = Q·K^T and
# the softmax in f32; l from the f32 P; P·V as P_hi·V + P_lo·V with
# P_hi = bf16(P), P_lo = bf16(P - P_hi); the output rounded to bf16. The
# limit is the smoke's: one bf16 rounding step of the reference.
TC_ROWS, TC_KEYS, TC_BLOCK = 64, 64, 128
BF16_RTOL, BF16_ATOL = 2**-7, 1e-4


def _tc_emulation(q, k, v, *, causal, window, softcap, split=True):
    """q, k, v: f32 tensors (B, H, S, D) holding bf16 values."""
    s, d = q.shape[-2:]
    scale = d**-0.5
    out = torch.zeros(q.shape, dtype=torch.bfloat16)

    def tile(x, lo):  # 64 rows from lo, zero past S (as TMA fills them)
        t = x[..., lo:lo + 64, :]
        return torch.nn.functional.pad(t, (0, 0, 0, 64 - t.shape[-2]))

    for q0 in range(0, s, TC_BLOCK):
        kv_end = min(s, q0 + TC_BLOCK) if causal else s
        kv_begin = (max(0, q0 - window + 1) // TC_KEYS) * TC_KEYS if window else 0
        n_tiles = -(-(kv_end - kv_begin) // TC_KEYS)
        for r0 in range(q0, min(q0 + TC_BLOCK, s), TC_ROWS):
            r_last = min(r0 + TC_ROWS, s) - 1
            t_lo, t_hi = 0, n_tiles - 1
            if causal:
                t_hi = min(t_hi, (r_last - kv_begin) // TC_KEYS)
            if window:
                t_lo = (max(0, r0 - window + 1) - kv_begin) // TC_KEYS
            rows = torch.arange(r0, r0 + TC_ROWS)[:, None]
            qt = tile(q, r0)
            m = torch.full(q.shape[:-2] + (TC_ROWS, 1), NEG_INF_F32)
            l = torch.zeros_like(m)
            acc = torch.zeros(q.shape[:-2] + (TC_ROWS, d))
            for t in range(t_lo, t_hi + 1):
                k0 = kv_begin + t * TC_KEYS
                keys = torch.arange(k0, k0 + TC_KEYS)[None, :]
                sc = (qt @ tile(k, k0).transpose(-1, -2)) * scale
                if softcap:
                    sc = softcap * torch.tanh(sc / softcap)
                visible = torch.ones(TC_ROWS, TC_KEYS, dtype=torch.bool)
                if causal:
                    visible &= keys <= rows
                if window:
                    visible &= keys > rows - window
                sc = torch.where(visible, sc, NEG_INF_F32)
                sc = torch.where(keys >= s, -torch.inf, sc)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                vt = tile(v, k0)
                p_hi = p.bfloat16().float()
                pv = p_hi @ vt + ((p - p_hi).bfloat16().float() @ vt if split else 0.0)
                acc, m = acc * alpha + pv, m_new
            n = min(TC_ROWS, s - r0)
            out[..., r0:r0 + n, :] = (acc / l.clamp_min(1e-30))[..., :n, :].bfloat16()
    return out


NEG_INF_F32 = torch.tensor(fa.NEG_INF, dtype=torch.float32)


def _bf16_inputs(shape, seed):
    """bf16 q, k, v from numpy normals, as JAX arrays and as f32 torch tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()
        out.append((jnp.asarray(a.numpy(), jnp.bfloat16), a))
    return out


def _limit_ratio(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / (BF16_ATOL + BF16_RTOL * np.abs(want))).max())


def _jax_block(s):
    return next(b for b in (128, 100, 96, 64, 40, 32) if s % b == 0)


@pytest.mark.parametrize(
    "b,h,s,d,causal,window,softcap",
    [
        (1, 2, 256, 64, True, None, None),
        (1, 1, 200, 64, True, 70, None),     # S not a multiple of the key tile; a window
        (1, 1, 256, 256, True, 64, 50.0),    # gemma2-9b's head_dim, window and softcap
        (1, 2, 160, 256, True, None, 30.0),  # D 256, ragged S, softcap
        (1, 1, 192, 64, False, None, None),  # no causal mask
        (2, 1, 320, 64, True, 100, None),    # a window that starts inside a 128-row block
    ],
)
def test_tensor_core_arithmetic_matches_pallas_kernel(b, h, s, d, causal, window, softcap):
    (jq, q), (jk, k), (jv, v) = _bf16_inputs((b, h, s, d), seed=s + d)
    blk = _jax_block(s)
    want = J_fa.flash_attention(jq, jk, jv, causal=causal, window=window, softcap=softcap, block_q=blk,
                                block_kv=blk)
    got = _tc_emulation(q, k, v, causal=causal, window=window, softcap=softcap)
    assert _limit_ratio(got.float().numpy(), jnp.asarray(want, jnp.float32)) <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounding_p_once_fails_the_limit_and_the_split_passes(seed):
    """Why the kernel computes P·V as two bf16 products: at S 512, D 64,
    causal, rounding P to bf16 once misses one bf16 step of the reference
    several times over; P_hi + P_lo stays within it."""
    (jq, q), (jk, k), (jv, v) = _bf16_inputs((1, 2, 512, 64), seed=seed)
    want = jnp.asarray(J_fa.flash_attention(jq, jk, jv, causal=True), jnp.float32)
    once = _tc_emulation(q, k, v, causal=True, window=None, softcap=None, split=False)
    split = _tc_emulation(q, k, v, causal=True, window=None, softcap=None)
    assert _limit_ratio(once.float().numpy(), want) > 4.0
    assert _limit_ratio(split.float().numpy(), want) <= 1.0


# ------------------------------- head dims the CUDA kernels are not built for
# The CUDA wrappers zero-pad D up to the next of HEAD_DIMS (32, 64, 128, 256)
# and drop the padded output columns. On the CPU the wrappers run the plain
# version at the real D; the tests below also run the plain version on the
# padded operands exactly as the wrappers build them for the kernel.
@pytest.mark.parametrize("d,dp", [(1, 32), (12, 32), (16, 32), (32, 32), (33, 64), (96, 128), (200, 256), (256, 256)])
def test_padded_head_dim(d, dp):
    assert fa.padded_head_dim(d) == dp == fa.padded_head_dim(d, dec.HEAD_DIMS)


def test_head_dims_above_256_are_refused():
    with pytest.raises(ValueError):
        fa.padded_head_dim(257)


def test_kernel_operand_pads_or_copies_only_when_needed():
    base = torch.arange(2 * 65, dtype=torch.bfloat16)
    aligned = base[:128].view(2, 64)
    assert fa.kernel_operand(aligned, 64) is aligned
    shifted = base[1:129].view(2, 64)  # contiguous, but 2 bytes past a 16-byte boundary
    assert shifted.data_ptr() % 16
    copy = fa.kernel_operand(shifted, 64)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, shifted)
    padded = fa.kernel_operand(aligned[:, :48].contiguous(), 64)
    assert padded.shape == (2, 64) and torch.equal(padded[:, :48], aligned[:, :48]) and not padded[:, 48:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, 30.0)], ids=["causal", "window-softcap"])
def test_flash_at_d96_matches_pallas_kernel(window, softcap, dtype):
    """phi-3-vision's head_dim (src/repro/configs/phi3_vision.py)."""
    (jq, q), (jk, k), (jv, v) = (_both((1, 2, 256, 96), dtype, seed) for seed in (21, 22, 23))
    kw = dict(causal=True, window=window, softcap=softcap)
    want = _np32(J_fa.flash_attention(jq, jk, jv, block_q=128, block_kv=128, **kw))
    tol = DTYPES[dtype][3]
    got = ops.flash_attention(q, k, v, **kw)
    assert got.shape == (1, 2, 256, 96)
    np.testing.assert_allclose(_np32(got), want, rtol=tol, atol=tol)
    dp = fa.padded_head_dim(96)
    padded = fa.flash_attention_torch(*(fa.kernel_operand(t, dp) for t in (q, k, v)), scale=96**-0.5, **kw)
    assert padded.shape[-1] == 128
    np.testing.assert_allclose(_np32(padded[..., :96]), want, rtol=tol, atol=tol)


def test_decode_at_d96_matches_pallas_kernel():
    jx, tx = _decode_inputs(2, 4, 512, 96, seed=31, kv_dtype="bf16", cache=[100, 512])
    want = np.asarray(J_ops.decode_attention(*jx, block_s=128))
    got = ops.decode_attention(*tx, block_s=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    q, k, v, cl = tx
    dp = fa.padded_head_dim(96, dec.HEAD_DIMS)
    o, m, l = dec.decode_attention_partials_torch(*(fa.kernel_operand(t, dp) for t in (q.float(), k, v)), cl,
                                                  scale=96**-0.5, block_s=128)
    assert o.shape[-1] == 128
    np.testing.assert_allclose(dec.merge_partials(o[..., :96], m, l)[0].numpy(), want, rtol=2e-5, atol=2e-5)


# ------------------------------------------ the split-K decode's arithmetic
# csrc/decode_attention.cu on the merged path cannot run here. This emulation
# repeats its arithmetic on the CPU: each row's keys below cache_len in splits
# of `split` keys, each split an online softmax over key tiles (16 KB of K a
# tile, at most 64 keys) with m, l and o carried across the tiles; a split at
# or past cache_len is neither computed nor merged; a row with cache_len = 0
# scores all S keys -1e30 without reading K (every p is 1); the splits are
# merged as merge_partials does. The limit is the existing decode tests' 2e-5.
EMU_SPLIT = 128  # smaller than the kernel's SPLIT, so that the tests' caches hold several splits


def _tile(d, dtype):
    return min(64, 16384 // (fa.padded_head_dim(d, dec.HEAD_DIMS) * (2 if dtype == torch.bfloat16 else 4)))


def _split_emulation(q, k, v, cache_len, *, split=EMU_SPLIT, softcap=None, scale=None):
    tile = _tile(q.shape[-1], k.dtype)
    q, k, v = q.float(), k.float(), v.float()
    bh, gq, d = q.shape
    s = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    out = torch.empty((bh, gq, d))
    for r in range(bh):
        n = int(cache_len[r])
        masked = n <= 0
        end = s if masked else min(n, s)
        parts = []
        for j0 in range(0, end, split):
            j1 = min(j0 + split, end)
            m = torch.full((gq, 1), -torch.inf)
            l = torch.zeros((gq, 1))
            acc = torch.zeros((gq, d))
            for t0 in range(j0, j1, tile):
                t1 = min(t0 + tile, j1)
                if masked:
                    sc = torch.full((gq, t1 - t0), dec.NEG_INF)
                else:
                    sc = (q[r] @ k[r, t0:t1].T) * scale
                    if softcap is not None:
                        sc = softcap * torch.tanh(sc / softcap)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc, m = acc * alpha + p @ v[r, t0:t1], m_new
            parts.append((acc / l.clamp_min(1e-30), m, l))
        o, m, l = (torch.stack(x) for x in zip(*parts))
        out[r] = dec.merge_partials(o, m, l, axis=0)[0]
    return out


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("bh,gq,s,d,block_s", DECODE_CASES)
def test_split_arithmetic_matches_pallas_kernel(bh, gq, s, d, block_s, softcap):
    jx, tx = _decode_inputs(bh, gq, s, d, seed=bh * 10 + gq)
    want = np.asarray(J_ops.decode_attention(*jx, block_s=block_s, softcap=softcap))
    got = _split_emulation(*tx, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "bh,gq,s,d,kv_dtype,cache",
    [
        (3, 4, 512, 64, "f32", [0, 200, 512]),  # an empty row: the mean of all of v
        (2, 4, 512, 128, "bf16", [77, 512]),  # a bf16 cache
        (3, 8, 512, 64, "f32", [EMU_SPLIT - 1, EMU_SPLIT, EMU_SPLIT + 1]),  # at a split boundary
        (3, 2, 512, 256, "bf16", [2 * EMU_SPLIT - 1, 2 * EMU_SPLIT, 2 * EMU_SPLIT + 1]),  # 32-key tiles
    ],
    ids=["empty-row", "bf16-cache", "split-boundary", "split-boundary-d256"],
)
def test_split_arithmetic_edges_match_pallas_kernel(bh, gq, s, d, kv_dtype, cache):
    jx, tx = _decode_inputs(bh, gq, s, d, seed=41 + d, kv_dtype=kv_dtype, cache=cache)
    want = np.asarray(J_dec.decode_attention(*jx, block_s=128))
    got = _split_emulation(*tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    if cache[0] == 0:
        np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(tx[2][0].float().numpy().mean(0), (gq, d)),
                                   rtol=1e-5, atol=1e-6)


def test_split_arithmetic_at_d96_on_padded_operands():
    """D = 96: the kernel reads K and V zero-padded to 128 columns and q
    zero-extended in shared memory; the padded columns of o are dropped."""
    jx, tx = _decode_inputs(2, 4, 512, 96, seed=31, kv_dtype="bf16", cache=[100, 512])
    want = np.asarray(J_ops.decode_attention(*jx, block_s=128))
    q, k, v, cl = tx
    dp = fa.padded_head_dim(96, dec.HEAD_DIMS)
    padded = _split_emulation(fa.kernel_operand(q, dp), fa.kernel_operand(k, dp), fa.kernel_operand(v, dp), cl,
                              scale=96**-0.5)
    assert padded.shape[-1] == dp and not padded[..., 96:].any()
    np.testing.assert_allclose(padded[..., :96].numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bh,gq,s,d,block_s", DECODE_CASES)
def test_merging_only_tiles_below_cache_len_equals_merging_all(bh, gq, s, d, block_s):
    """With every cache_len >= 1, a tile wholly past cache_len has weight
    l * exp(-1e30 - m_max) = 0 exactly in the merge: leaving it out, as the
    CUDA path does, changes nothing."""
    _, (q, k, v, cl) = _decode_inputs(bh, gq, s, d, seed=51)
    assert int(cl.min()) >= 1
    o, m, l = dec.decode_attention_partials(q, k, v, cl, block_s=block_s)
    every = dec.merge_partials(o, m, l)[0]
    for r in range(bh):
        n = -(-int(cl[r]) // block_s)
        below = dec.merge_partials(o[r:r + 1, :n], m[r:r + 1, :n], l[r:r + 1, :n])[0]
        torch.testing.assert_close(below[0], every[r], rtol=1e-6, atol=1e-6)
