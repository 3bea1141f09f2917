"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy-seeded inputs.

Tolerances are tests/test_kernels.py's: 2e-5 in f32 (sums run in another
order than XLA's), 2e-2 in bf16. MoE routing is held exactly: the expert ids
of every token and the set of (token, k) entries kept under the capacity. A
near-tie in routing would show as a failure here; it is reported, never
re-seeded away.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as J_configs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs
from repro_torch.models import dist, layers

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _pair(a: np.ndarray, dt: str):
    """The same values as a jnp array and a torch tensor of dtype ``dt``
    (integer arrays keep their dtype)."""
    if a.dtype.kind in "iub":
        return jnp.asarray(a), torch.from_numpy(a)
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _params(tree: dict, dt: str):
    """A numpy tree as a jnp tree and a torch dict of the same values; the
    router, a_log and dt_bias stay float32 as the reference keeps them."""
    j, t = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            j[k], t[k] = _params(v, dt)
        else:
            j[k], t[k] = _pair(v, "f32" if k in ("router", "a_log", "dt_bias") else dt)
    return j, t


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def _tree_from(cfg, seed, scale=0.05):
    """One layer's weights of ``cfg`` (the stacked tree at layer 0), every
    leaf random."""
    shapes = jax.eval_shape(lambda k: JM.init_params(cfg, k), jax.random.PRNGKey(0))["layers"]

    def draw(t, path):
        out = {}
        for k, s in t.items():
            if isinstance(s, dict):
                out[k] = draw(s, path + (k,))
                continue
            z = _rng(seed, len(out), len(path)).standard_normal(s.shape[1:])
            if k == "d_skip":
                out[k] = (1.0 + 0.3 * z).astype(np.float32)
            elif k in ("router", "a_log", "dt_bias", "bq", "bk", "bv") or s.ndim == 2:  # router, biases, norms
                out[k] = (0.5 * z).astype(np.float32)
            elif k == "conv_w":
                out[k] = (0.2 * z).astype(np.float32)
            else:
                out[k] = (scale * z).astype(np.float32)
        return out

    return draw(shapes, ())


# ------------------------------------------------------------ norms and rope
@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm_and_layer_norm(dt):
    tol = DTYPES[dt][2]
    r = _rng(0)
    x, w, b = r.standard_normal((2, 5, 64)) * 3, r.standard_normal(64) * 0.3, r.standard_normal(64) * 0.3
    (jx, tx), (jw, tw), (jb, tb) = _pair(x, dt), _pair(w, dt), _pair(b, dt)
    got = layers.rms_norm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, JL.rms_norm(jx, jw, 1e-6), tol)
    _close(layers.layer_norm(tx, tw, tb), JL.layer_norm(jx, jw, jb), tol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("theta,offset", [(10_000.0, 0), (1_000_000.0, 37)])
def test_rope(dt, theta, offset):
    tol = DTYPES[dt][2]
    x = _rng(1).standard_normal((2, 4, 33, 16))
    jx, tx = _pair(x, dt)
    pos = np.arange(33) + offset
    got = layers.rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    _close(got, JL.rope(jx, jnp.asarray(pos), theta), tol)


# ----------------------------------------------------------------- attention
ATTN_CASES = {
    # name: (B, H, Hkv, Sq, Sk, hd, kwargs)
    "causal": (2, 4, 4, 40, 40, 16, dict()),
    "window": (2, 4, 4, 40, 40, 16, dict(window=8)),
    "window-zero-is-global": (2, 4, 4, 40, 40, 16, dict(window=0)),
    "softcap": (2, 4, 4, 40, 40, 16, dict(softcap=5.0)),
    "gqa": (2, 8, 2, 40, 40, 16, dict(window=12, softcap=20.0)),
    "non-causal": (2, 4, 2, 24, 40, 16, dict(causal=False)),
    "q-offset-kv-len": (2, 4, 2, 3, 64, 16, dict(q_offset=30, kv_len=np.array([33, 33], np.int32))),
    "decode-kv-len-by-row": (3, 4, 2, 1, 48, 16, dict(q_offset=20, kv_len=np.array([21, 9, 48], np.int32),
                                                      window=6)),
    "small-blocks-halved": (2, 4, 2, 40, 40, 16, dict(block_q=16, block_kv=12, window=10)),
    "odd-s": (1, 2, 1, 37, 37, 8, dict(block_q=8, block_kv=8)),
    "s-not-multiple-of-512": (1, 2, 1, 1100, 1100, 8, dict(window=300)),
}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_mea_attention(dt, case):
    b, h, hkv, sq, sk, hd, kw = ATTN_CASES[case]
    tol = DTYPES[dt][2]
    r = _rng(2, len(case))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(r.standard_normal(s), dt)
                                    for s in ((b, h, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd)))
    jkw, tkw = dict(kw), dict(kw)
    if "kv_len" in kw:
        jkw["kv_len"], tkw["kv_len"] = jnp.asarray(kw["kv_len"]), torch.from_numpy(kw["kv_len"])
    if "window" in kw:
        jkw["window"] = jnp.asarray(kw["window"], jnp.int32)
    got = layers.mea_attention(tq, tk, tv, **tkw)
    assert got.dtype == tq.dtype and got.shape == (b, h, sq, hd)
    _close(got, JL.mea_attention(jq, jk, jv, **jkw), tol, case)


ATTN_CFGS = ["qwen2-1.5b", "qwen3-8b", "gemma2-9b", "gemma3-4b"]  # bias, qk-norm, softcap + window, GQA


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ATTN_CFGS)
def test_attention_block_without_cache(dt, arch):
    cfg = configs.get_smoke(arch)
    tol = DTYPES[dt][2]
    jp, tp = _params(_tree_from(cfg, 3), dt)
    jx, tx = _pair(_rng(4).standard_normal((2, 40, cfg.d_model)), dt)
    w = cfg.window or 0
    out, cache = layers.attention_block(tp, tx, cfg, window=w)
    want, _ = JL.attention_block(jp, jx, cfg, window=jnp.asarray(w, jnp.int32))
    assert cache is None
    _close(out, want, tol, arch)
    out, _ = layers.attention_block(tp, tx, cfg, window=0, causal=False)
    want, _ = JL.attention_block(jp, jx, cfg, window=jnp.asarray(0, jnp.int32), causal=False)
    _close(out, want, tol, arch)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ATTN_CFGS)
def test_attention_block_with_cache(dt, arch):
    """A prefill of 36 positions into a cache of 48, then one step at 36:
    the output and the cache written in place equal the reference's."""
    cfg = configs.get_smoke(arch)
    tol = DTYPES[dt][2]
    jp, tp = _params(_tree_from(cfg, 5), dt)
    w = cfg.window or 0
    jw = jnp.asarray(w, jnp.int32)
    shape = (2, cfg.num_kv_heads, 48, cfg.head_dim)
    jc = {"k": jnp.zeros(shape, DTYPES[dt][0]), "v": jnp.zeros(shape, DTYPES[dt][0]), "pos": jnp.asarray(0, jnp.int32)}
    tc = {"k": torch.zeros(shape, dtype=DTYPES[dt][1]), "v": torch.zeros(shape, dtype=DTYPES[dt][1]), "pos": 0}
    for s, pos, seed in ((36, 0, 6), (1, 36, 7)):
        jx, tx = _pair(_rng(seed).standard_normal((2, s, cfg.d_model)), dt)
        jc["pos"], tc["pos"] = jnp.asarray(pos, jnp.int32), pos
        out, new = layers.attention_block(tp, tx, cfg, window=w, q_offset=pos, cache=tc)
        want, jnew = JL.attention_block(jp, jx, cfg, window=jw, q_offset=pos, cache=jc)
        assert new["k"] is tc["k"] and new["v"] is tc["v"]  # written in place
        _close(out, want, tol, f"{arch} out at {pos}")
        _close(tc["k"], jnew["k"], tol, f"{arch} k at {pos}")
        _close(tc["v"], jnew["v"], tol, f"{arch} v at {pos}")
        jc.update(jnew)


def test_attention_block_cache_overrun_raises():
    cfg = configs.get_smoke("qwen2-1.5b")
    _, tp = _params(_tree_from(cfg, 5), "f32")
    shape = (1, cfg.num_kv_heads, 8, cfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape), "pos": 6}
    with pytest.raises(ValueError, match="overruns"):
        layers.attention_block(tp, torch.zeros(1, 3, cfg.d_model), cfg, q_offset=6, cache=cache)


@pytest.mark.parametrize("dt", DTYPES)
def test_cross_attention_block(dt):
    cfg = configs.get_smoke("whisper-small")
    tol = DTYPES[dt][2]
    jp, tp = _params(_tree_from(cfg, 8)["cross"], dt)
    r = _rng(9)
    jx, tx = _pair(r.standard_normal((2, 7, cfg.d_model)), dt)
    kv = [_pair(r.standard_normal((2, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)), dt) for _ in range(2)]
    got = layers.cross_attention_block(tp, tx, (kv[0][1], kv[1][1]), cfg)
    _close(got, JL.cross_attention_block(jp, jx, (kv[0][0], kv[1][0]), cfg), tol)


# ----------------------------------------------------------------------- MLP
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-small"])  # SwiGLU, tanh-GELU
def test_mlp_block(dt, arch):
    cfg = configs.get_smoke(arch)
    tol = DTYPES[dt][2]
    tree = _tree_from(cfg, 10, scale=0.2)
    jp, tp = _params({k: tree[k] for k in ("w1", "w2", "w3") if k in tree}, dt)
    jx, tx = _pair(_rng(11).standard_normal((2, 9, cfg.d_model)), dt)
    _close(layers.mlp_block(tp, tx, cfg.act), JL.mlp_block(jp, jx, cfg.act), tol, arch)


# ----------------------------------------------------------------------- MoE
def _jax_route(x, router, cfg):
    """The reference's routing lines (``moe_block``, DP = 1) on jnp, giving
    each token's expert ids and each (token, k) entry's kept flag."""
    e, k, ea = cfg.num_experts, cfg.experts_per_token, cfg.experts_alloc
    tl = x.shape[1]
    cap = int(tl * k / e * cfg.capacity_factor) + 1
    logits = jnp.einsum("gtd,de->gte", x.astype(jnp.float32), router.astype(jnp.float32))
    if ea > e:
        logits = jnp.where(jnp.arange(ea)[None, None, :] < e, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    flat_e = expert_ids.reshape(1, tl * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    starts = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(ea)))(se)
    pos = jnp.arange(tl * k)[None, :] - jnp.take_along_axis(starts, se, axis=1)
    keep_of = jnp.zeros((1, tl * k), jnp.bool_).at[jnp.arange(1)[:, None], order].set(pos < cap)
    return np.asarray(expert_ids), np.asarray(keep_of)


MOE_CASES = {
    # deepseek: shared experts; granite with 12 allocated for 8 experts.
    "deepseek-shared": ("deepseek-moe-16b", dict(capacity_factor=1.25)),
    "granite-padded": ("granite-moe-3b-a800m", dict(capacity_factor=1.25, num_experts_alloc=12)),
    "deepseek-no-drops": ("deepseek-moe-16b", dict()),
}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block(dt, case):
    arch, over = MOE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke(arch), **over)
    jcfg = dataclasses.replace(J_configs.get_smoke(arch), **over)
    tol = DTYPES[dt][2]
    jp, tp = _params(_tree_from(cfg, 12, scale=0.2), dt)
    r = _rng(13)
    # A direction shared by every token skews the loads, so that at capacity
    # factor 1.25 some experts overflow.
    jx, tx = _pair(r.standard_normal((2, 24, cfg.d_model)) + 1.5 * r.standard_normal(cfg.d_model), dt)
    y, aux = layers.moe_block(tp, tx, cfg)
    jy, jaux = JL.moe_block(jp, jx, jcfg)
    assert y.dtype == tx.dtype and aux.dtype == torch.float32
    _close(y, jy, tol, case)
    _close(aux, jaux, 2e-5, case)

    r = layers.moe_route(tx.reshape(1, 48, cfg.d_model), tp["router"], cfg)
    ids, kept = _jax_route(jx.reshape(1, 48, cfg.d_model), jp["router"], jcfg)
    np.testing.assert_array_equal(r["expert_ids"].numpy(), ids)
    np.testing.assert_array_equal(r["kept"].numpy(), kept)
    assert (r["expert_ids"] < cfg.num_experts).all()  # padded experts carry nothing
    if cfg.capacity_factor < 2:
        assert not kept.all(), "the case must drop entries past the capacity"
    else:
        assert kept.all()


def test_moe_top_k_takes_the_lower_index_on_ties():
    """Experts 1, 3 and 6 have one router column, so their probabilities tie
    exactly: top-k takes the lower index first, as ``lax.top_k`` does."""
    cfg = dataclasses.replace(configs.get_smoke("granite-moe-3b-a800m"), experts_per_token=2)
    jcfg = dataclasses.replace(J_configs.get_smoke("granite-moe-3b-a800m"), experts_per_token=2)
    router = _rng(14).standard_normal((cfg.d_model, cfg.experts_alloc)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 6] = router[:, 1]
    router[:, 1] += 2.0 * np.sign(router[:, 1])  # make the tied column win often
    router[:, 3], router[:, 6] = router[:, 1], router[:, 1]
    x = _rng(15).standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    r = layers.moe_route(torch.from_numpy(x), torch.from_numpy(router), cfg)
    ids, kept = _jax_route(jnp.asarray(x), jnp.asarray(router), jcfg)
    np.testing.assert_array_equal(r["expert_ids"].numpy(), ids)
    np.testing.assert_array_equal(r["kept"].numpy(), kept)
    assert ((ids[..., 0] == 1) & (ids[..., 1] == 3)).sum() > 0  # the tie was met, and broken low-first


def test_dp_size_is_one_and_distributions_wait():
    """Without a distribution dp_size is 1; ``use_distribution`` makes one
    live for its block only (an exception in the block included), and
    dp_size is then the product of its batch axes, as the reference's."""
    from repro.models import dist as J_dist
    from repro_torch.launch import mesh as MM

    assert dist.dp_size() == 1 and dist.current() is None
    with dist.use_distribution(None):
        assert dist.current() is None
    grid = MM.make_production_mesh(multi_pod=True)
    for batch_axes, want in ((("pod", "data"), 32), (("data",), 16), ((), 1)):
        d = dist.Distribution(mesh=grid, batch_axes=batch_axes)
        with pytest.raises(RuntimeError, match="inside"):
            with dist.use_distribution(d):
                assert dist.current() is d and dist.dp_size() == want
                raise RuntimeError("inside")
        assert dist.current() is None and dist.dp_size() == 1
    ref, port = J_dist.Distribution(mesh=None), dist.Distribution(mesh=grid)
    fields = ("batch_axes", "seq_axes", "sp_decode", "tp_axis")
    assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert (port.batch_spec, port.seq_spec, port.tp_size, d.batch_spec) == (("data",), ("model",), 16, None)


# ----------------------------------------------------------------------- SSD
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("s,chunk", [(40, 16), (32, 256), (24, 8)])
def test_ssd_chunked(dt, s, chunk):
    tol = DTYPES[dt][2]
    r = _rng(16, s)
    b, h, p, n = 2, 3, 8, 5
    (jx, tx), (jb, tb), (jc, tc) = (_pair(a, dt) for a in (r.standard_normal((b, s, h, p)) * 0.5,
                                                           r.standard_normal((b, s, n)), r.standard_normal((b, s, n))))
    da = -np.abs(r.standard_normal((b, s, h))) * 0.3
    jda, tda = _pair(da, dt)
    y, st = layers._ssd_chunked(tx, tda, tb, tc, chunk)
    jy, jst = JL._ssd_chunked(jx, jda, jb, jc, chunk)
    _close(y, jy, tol, "y")
    _close(st, jst, tol, "state")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssd_block_prefill_then_decode(dt, arch):
    cfg = configs.get_smoke(arch)
    tol = DTYPES[dt][2]
    tree = _tree_from(cfg, 17, scale=0.1)
    jp, tp = _params(tree["ssm"] if "ssm" in tree else tree, dt)
    jx, tx = _pair(_rng(18).standard_normal((2, 40, cfg.d_model)), dt)
    y, (st, cv) = layers.ssd_block(tp, tx, cfg, chunk=16)
    jy, (jst, jcv) = JL.ssd_block(jp, jx, cfg, chunk=16)
    _close(y, jy, tol, "prefill y")
    _close(st, jst, tol, "prefill state")
    _close(cv, jcv, tol, "prefill conv state")
    jx1, tx1 = _pair(_rng(19).standard_normal((2, 1, cfg.d_model)), dt)
    y, (st2, cv2) = layers.ssd_block(tp, tx1, cfg, state=st, conv_state=cv)
    jy, (jst2, jcv2) = JL.ssd_block(jp, jx1, cfg, state=jst, conv_state=jcv)
    _close(y, jy, tol, "decode y")
    _close(st2, jst2, tol, "decode state")
    _close(cv2, jcv2, tol, "decode conv state")


# ------------------------------------------------------------------ the loss
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("variant", ["tied", "mask-softcap", "lm-head"])
def test_chunked_ce_loss(dt, variant):
    from repro_torch.models import model as M

    tol = DTYPES[dt][2]
    r = _rng(20, len(variant))
    b, s, d, v = 2, 40, 16, 64
    jx, tx = _pair(r.standard_normal((b, s, d)), dt)
    je, te = _pair(r.standard_normal((v, d)) * 0.5, dt)
    jt, tt = _pair(r.integers(0, v, (b, s)).astype(np.int32), dt)
    kw, jkw = {"chunk": 16}, {"chunk": 16}
    if variant == "mask-softcap":
        mask = (r.random((b, s)) < 0.7).astype(np.float32)
        jkw["mask"], kw["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
        jkw["softcap"] = kw["softcap"] = 3.0
    if variant == "lm-head":
        jkw["lm_head"], kw["lm_head"] = _pair(r.standard_normal((d, v)) * 0.5, dt)
    got = M.chunked_ce_loss(tx, te, tt, **kw)
    assert got.dtype == torch.float32
    _close(got, JM.chunked_ce_loss(jx, je, jt, **jkw), tol, variant)
