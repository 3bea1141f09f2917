"""Neural building blocks shared by the 10 architectures, in PyTorch.

The counterpart of ``repro.models.layers``: the same functions under the same
names, on tensors. Attention is the reference's memory-efficient plain
attention (an online softmax over key blocks), computed in torch ops as the
reference computes it in jnp, so no (S x S) score matrix is materialised.
Per-layer sliding windows, soft caps, qk-norm and QKV bias cover the
gemma/qwen/phi variants.

Mixed dtypes promote as in jnp (bf16 with f32 gives f32): every contraction
goes through ``_einsum``, which casts its operands to their promoted type.

The reference's ``jax.checkpoint`` sites (``nothing_saveable``) go through
``remat``: under autograd backward recomputes the wrapped body from its
inputs; with gradients off (serving under ``torch.inference_mode()``) the
body is a direct call.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from . import dist as _dist

NEG_INF = -1e30


def remat(fn, *args):
    """``fn(*args)``; while autograd records, as ``jax.checkpoint(fn,
    policy=nothing_saveable)``: only the inputs are saved and backward runs
    ``fn`` again. Non-reentrant, so checkpoints nest (a layer's holds its
    attention's) and parameters read inside ``fn`` get their gradients. The
    forwards draw no random numbers, so no RNG state is stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _silu(x):
    """``jax.nn.silu`` op by op (x · 1 / (1 + e^-x)), so that in bf16 each
    step rounds where the reference's does."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_tanh(x):
    """``jax.nn.gelu`` (the tanh approximation) op by op, its constants in
    x's dtype, as the reference computes it."""
    c = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    k = torch.tensor((2 / torch.pi) ** 0.5, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(k * (x + c * (x * x * x)))))


# ---------------------------------------------------------------- norms/rope
def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, hd); positions: (S,) absolute positions. Half-split
    rotation (the first half of hd against the second), not interleaved."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs[None, :]  # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------- chunked attention
def _mask_scores(s, q_pos, k_pos, *, causal, window, kv_len):
    """s: (B, ..., bq, bk) f32; window: int (0 ⇒ global); kv_len: int or (B,)."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None and window > 0:
        mask = mask & (kp > qp - window)
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor):
            lead = (1,) * (s.dim() - 3)
            mask = mask & (kp < kv_len.view(-1, *lead, 1, 1))
        else:
            mask = mask & (kp < kv_len)
    return torch.where(mask, s, NEG_INF)


def mea_attention(
    q,  # (B, H, Sq, hd)
    k,  # (B, Hkv, Sk, hd); query head h reads KV head h // (H / Hkv) (GQA)
    v,
    *,
    causal: bool = True,
    window=None,  # None | int (0 ⇒ global, > 0 ⇒ sliding)
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len=None,  # None | int | (B,) valid cache lengths
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 1024,
):
    """Memory-efficient attention: a loop over query rows × key blocks with an
    online softmax; O(Sq·hd + bq·bk) live memory instead of O(Sq·Sk).

    The key axis is cut as the reference cuts it: ``block_kv`` halved until it
    divides Sk, and the blocks merged in order, so the running max, sum and
    accumulator see the same blocks. The query rows are independent, so they
    go in slices of up to ``block_q`` rows, whole multiples of the
    reference's halved query block (an odd Sq would otherwise take one row a
    step). GQA groups the query heads over their KV head (a view, no copy):
    the reference's ``jnp.repeat`` gives each KV head to H / Hkv consecutive
    query heads, the same pairing.
    """
    b, hq, sq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    sk = k.shape[2]
    scale = (hd**-0.5) if scale is None else scale
    window = None if window is None else int(window)
    bq = min(block_q, sq)
    bk = min(block_kv, sk)
    while sq % bq:
        bq //= 2
    while sk % bk:
        bk //= 2
    bq, bk = max(bq, 1), max(bk, 1)
    q_step = bq * max(1, block_q // bq)
    dev = q.device

    def rows(q0: int, n: int, q, k, v):
        """The n query rows from q0 over every key block."""
        qc = q[:, :, q0 : q0 + n].float().reshape(b, hkv, g * n, hd)
        q_pos = (q_offset + q0 + torch.arange(n, device=dev)).repeat(g)
        m = torch.full((b, hkv, g * n), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g * n), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g * n, hd), dtype=torch.float32, device=dev)
        for k0 in range(0, sk, bk):
            kc = k[:, :, k0 : k0 + bk].float()
            vc = v[:, :, k0 : k0 + bk].float()
            s = torch.matmul(qc, kc.transpose(-1, -2)) * scale  # (B, Hkv, G·n, bk)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            k_pos = k0 + torch.arange(bk, device=dev)
            s = _mask_scores(s, q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vc)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        return o.reshape(b, hq, n, hd).to(q.dtype)

    # Each query slice is a remat site (the reference checkpoints its q-step):
    # backward recomputes the slice's online softmax instead of keeping its
    # (G·n, bk) score blocks.
    out = torch.empty((b, hq, sq, hd), dtype=q.dtype, device=dev)
    for q0 in range(0, sq, q_step):
        n = min(q_step, sq - q0)
        out[:, :, q0 : q0 + n] = remat(rows, q0, n, q, k, v)
    return out


# -------------------------------------------------------------- attention block
def attention_block(
    p,
    x,  # (B, S, D)
    cfg,
    *,
    window=None,
    causal: bool = True,
    q_offset: int = 0,
    cache: Optional[dict] = None,  # {"k","v": (B,Hkv,Smax,hd), "pos": int}
    kv_len=None,
    positions=None,
):
    """Self-attention with RoPE/GQA/qk-norm/bias/softcap; optional KV cache.

    Projections are head-split 3-D tensors (D, H, hd). With a cache, this
    step's K/V are written into ``cache["k"]`` / ``cache["v"]`` in place at
    ``cache["pos"]`` and attention reads the cache below ``pos + S``."""
    b, s, d = x.shape
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    k = _einsum("bsd,dhk->bshk", x, p["wk"])
    v = _einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = q.transpose(1, 2)  # (B, Hq, S, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if positions is None:
        positions = q_offset + torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    sp_out = None
    dst = _dist.current() if cache is not None else None
    if dst is not None and dst.seq_axes:
        # This rank holds a slice of the cache's sequence axis.
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        s_loc = ck.shape[2]
        total = s_loc * dst.seq_ranks
        if pos + s > total:
            raise ValueError(f"the cache holds {total} positions; writing {s} at {pos} overruns it")
        if dst.sp_decode and s == 1:
            # Sequence-parallel decode: the owner writes, every rank attends
            # over its slice, the partials merge by log-sum-exp.
            _dist.sp_cache_update(dst, ck, k, pos)
            _dist.sp_cache_update(dst, cv, v, pos)
            sp_out = _dist.sp_decode_attention(
                dst, q, ck, cv, pos, window=window, softcap=cfg.attn_softcap, scale=cfg.head_dim**-0.5,
            )
        elif pos == 0:
            # Prefill: attend over the prompt's own K/V; keep this rank's slice.
            lo = dst.seq_start(s_loc)
            n = max(0, min(s - lo, s_loc))
            ck[:, :, :n] = k[:, :, lo : lo + n].to(ck.dtype)
            cv[:, :, :n] = v[:, :, lo : lo + n].to(cv.dtype)
            kv_len = s if kv_len is None else kv_len
        else:
            raise ValueError(f"a sequence-sharded cache takes a prefill from position 0 or, with sp_decode, one "
                             f"token a step; got {s} tokens at {pos}")
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        if pos + s > ck.shape[2]:
            raise ValueError(f"the cache holds {ck.shape[2]} positions; writing {s} at {pos} overruns it")
        ck[:, :, pos : pos + s] = k.to(ck.dtype)
        cv[:, :, pos : pos + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        k, v = ck, cv
        kv_len = pos + s if kv_len is None else kv_len

    if sp_out is not None:
        out = sp_out
    else:
        out = mea_attention(
            q, k, v,
            causal=causal, window=window, softcap=cfg.attn_softcap,
            q_offset=q_offset, kv_len=kv_len,
        )
    out = out.transpose(1, 2)  # (B, S, Hq, hd)
    out = _einsum("bshk,hkd->bsd", out, p["wo"])
    return out, new_cache


def cross_attention_block(p, x, enc_kv, cfg):
    """Decoder cross-attention (whisper): kv from encoder output, no mask."""
    q = _einsum("bsd,dhk->bshk", x, p["wq"]).transpose(1, 2)
    k, v = enc_kv  # (B, Hkv, Se, hd) precomputed from encoder output
    out = mea_attention(q, k, v, causal=False, window=None, softcap=None)
    out = out.transpose(1, 2)
    return _einsum("bshk,hkd->bsd", out, p["wo"])


# --------------------------------------------------------------------- MLPs
def mlp_block(p, x, act: str = "silu"):
    if act == "gelu":  # non-gated (whisper); jax.nn.gelu is the tanh form
        h = _gelu_tanh(_einsum("bsd,df->bsf", x, p["w1"]))
        return _einsum("bsf,fd->bsd", h, p["w2"])
    h = _silu(_einsum("bsd,df->bsf", x, p["w1"]))
    h = h * _einsum("bsd,df->bsf", x, p["w3"])
    return _einsum("bsf,fd->bsd", h, p["w2"])


# ---------------------------------------------------------------------- MoE
def moe_route(x, router, cfg):
    """The router of ``moe_block``: (DP, T_loc, D) tokens → a dict of the
    softmax ``probs`` (DP, T_loc, E_alloc), the renormalised ``gates`` and
    ``expert_ids`` (DP, T_loc, K), the capacity ``cap``, and for every
    (token, k) entry in token order its ``slot`` in its expert's buffer and
    whether it is ``kept`` (an entry past the capacity goes to the trash slot
    ``cap`` and is dropped).

    Padded experts (``cfg.experts_alloc > num_experts``) get −1e30 logits.
    Top-k takes the lower expert index first on ties, as ``lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no order on ties).
    """
    dp, tl, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    ea = cfg.experts_alloc
    cap = int(tl * k / e * cfg.capacity_factor) + 1
    dev = x.device
    logits = _einsum("gtd,de->gte", x.float(), router.float())
    if ea > e:  # padded experts never win top-k
        logits = torch.where(torch.arange(ea, device=dev) < e, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = vals[..., :k], idx[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_e = expert_ids.reshape(dp, tl * k)
    order = torch.sort(flat_e, dim=1, stable=True).indices
    se = torch.gather(flat_e, 1, order)  # sorted expert ids
    starts = torch.searchsorted(se, torch.arange(ea, device=dev).expand(dp, ea).contiguous())
    pos = torch.arange(tl * k, device=dev)[None, :] - torch.gather(starts, 1, se)
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap)  # overflow → trash slot
    slot = torch.empty_like(pos_c).scatter_(1, order, pos_c)
    kept = torch.empty_like(keep).scatter_(1, order, keep)
    return {"probs": probs, "gates": gates, "expert_ids": expert_ids, "cap": cap, "order": order,
            "sorted_ids": se, "sorted_slot": pos_c, "sorted_kept": keep, "slot": slot, "kept": kept}


def moe_block(p, x, cfg):
    """Top-k routed experts with DP-local capacity dispatch + shared experts.

    Tokens are grouped as (DP, T_loc, …) with DP 1: a rank's tokens are one group. Each expert's
    buffer holds ``cap`` tokens plus a trash slot; the buffers are gathered
    from the tokens, run through the experts' SwiGLU, and each (token, k)
    entry's output gathered back and weighted by its gate (0 if dropped).
    Returns (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    ea = cfg.experts_alloc
    t = b * s
    # The reference splits the global tokens into dp_size() groups of
    # contiguous batch rows. Under a distribution this rank holds exactly one
    # such group (Distribution.batch_rows), and without one there is one
    # group: either way the tokens here route as one group.
    dp = 1
    tl = t // dp
    dev = x.device

    xf = x.reshape(dp, tl, d)
    r = moe_route(xf, p["router"], cfg)
    cap = r["cap"]
    gidx = torch.arange(dp, device=dev)[:, None]
    st = r["order"] // k  # token index of each sorted entry
    # slot → token map (tl = the sentinel row of zeros).
    inv = torch.full((dp, ea, cap + 1), tl, dtype=torch.int64, device=dev)
    inv[gidx, r["sorted_ids"], r["sorted_slot"]] = torch.where(r["sorted_kept"], st, tl)

    xf_pad = torch.cat([xf, torch.zeros((dp, 1, d), dtype=x.dtype, device=dev)], dim=1)
    buf = xf_pad[gidx[:, :, None], inv]  # (DP, E, C+1, D) gather
    h = _silu(_einsum("gecd,edf->gecf", buf, p["w1"]))
    h = h * _einsum("gecd,edf->gecf", buf, p["w3"])
    ye = _einsum("gecf,efd->gecd", h, p["w2"])
    flat_e = r["expert_ids"].reshape(dp, tl * k)
    contrib = ye[gidx, flat_e, r["slot"]]  # (DP, TK, D)
    w = r["gates"].reshape(dp, tl * k) * r["kept"].float()
    yf = torch.sum(contrib.reshape(dp, tl, k, d).float() * w.reshape(dp, tl, k, 1), dim=2)
    y = yf.reshape(b, s, d).to(x.dtype)

    if cfg.num_shared_experts:
        y = y + mlp_block(p["shared"], x, cfg.act)

    # Load-balance aux loss (Switch-style): E · Σ_e f_e · P_e.
    inc = torch.zeros(ea, dtype=torch.float32, device=dev).index_add_(
        0, flat_e.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=dev)) / (t * k)
    pe = r["probs"].mean(dim=(0, 1))
    aux = e * torch.sum(inc * pe)
    return y, aux


# ----------------------------------------------------------------- SSD (mamba2)
def _ssd_chunked(xbar, dA, B_, C_, chunk: int):
    """Chunked state-space-duality scan (Mamba2 §6), one chunk at a time.

    xbar: (B,S,H,P) inputs pre-multiplied by dt; dA: (B,S,H) log-decay per step;
    B_, C_: (B,S,N) shared across heads (ngroups=1). Returns y (B,S,H,P) and
    final state (B,H,P,N).
    """
    b, s, h, pdim = xbar.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    c = s // q
    xb = xbar.reshape(b, c, q, h, pdim)
    da = dA.reshape(b, c, q, h)
    bb = B_.reshape(b, c, q, n)
    cc = C_.reshape(b, c, q, n)

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xbar.device))[None, :, :, None]

    def step(st_prev, xbc, dac, bbc, ccc):
        """One chunk: (the state after it, its outputs)."""
        cums = torch.cumsum(dac.float(), dim=1)  # (B,q,H)
        li = cums[:, :, None, :] - cums[:, None, :, :]  # (B,i,j,H)
        l_mat = torch.where(tri, torch.exp(li), 0.0)
        g = _einsum("bin,bjn->bij", ccc, bbc)  # (B,q,q)
        m = g[..., None] * l_mat  # (B,i,j,H)
        y_diag = _einsum("bijh,bjhp->bihp", m.to(xbc.dtype), xbc)
        decay = torch.exp(cums[:, -1:, :] - cums).to(xbc.dtype)  # (B,q,H)
        st_c = _einsum("bjn,bjh,bjhp->bhpn", bbc, decay, xbc)
        y_off = _einsum("bqn,bhpn,bqh->bqhp", ccc, st_prev, torch.exp(cums).to(xbc.dtype))
        chunk_decay = torch.exp(cums[:, -1, :]).to(xbc.dtype)  # (B,H)
        return st_prev * chunk_decay[:, :, None, None] + st_c, y_diag + y_off

    # Each chunk step is a remat site, as in the reference: the O(q²·H)
    # intra-chunk tensors are recomputed in backward, not kept.
    st = torch.zeros((b, h, pdim, n), dtype=xbar.dtype, device=xbar.device)
    ys = []
    for i in range(c):
        st, y_c = remat(step, st, xb[:, i], da[:, i], bb[:, i], cc[:, i])
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(b, s, h, pdim)
    return y, st


def ssd_block(p, x, cfg, *, state=None, conv_state=None, chunk: int = 256):
    """Mamba2 block. Training/prefill: chunked SSD over the sequence.
    Decode (S == 1 with state): O(1) recurrent update.
    Returns (y, (new_state, new_conv_state))."""
    b, s, d = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim
    zxbc = _einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xi, b_, c_, dt = torch.split(zxbc, [di, di, n, n, zxbc.shape[-1] - 2 * di - 2 * n], dim=-1)
    conv_in = torch.cat([xi, b_, c_], dim=-1)  # (B,S,di+2n)

    w = p["conv_w"]  # (K, di+2n) depthwise causal conv
    kw = w.shape[0]
    if state is None:  # train/prefill: causal depthwise conv over seq
        pad = torch.zeros((b, kw - 1, conv_in.shape[-1]), dtype=conv_in.dtype, device=x.device)
        ext = torch.cat([pad, conv_in], dim=1)
        conv = sum(ext[:, i : i + s] * w[i] for i in range(kw))
        if kw > 1:
            new_conv_state = ext[:, -(kw - 1) :]
        else:
            new_conv_state = torch.zeros((b, 0, conv_in.shape[-1]), dtype=x.dtype, device=x.device)
    else:  # decode: rolling window
        ext = torch.cat([conv_state, conv_in], dim=1)  # (B, kw, C)
        conv = sum(ext[:, i : i + 1] * w[i] for i in range(kw))
        new_conv_state = ext[:, 1:]
    conv = _silu(conv)
    xi, b_, c_ = torch.split(conv, [di, n, conv.shape[-1] - di - n], dim=-1)

    a = -torch.exp(p["a_log"].float())  # (H,)
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # softplus, as jax.nn.softplus
    xh = xi.reshape(b, s, h, pdim)
    xbar = xh * dt[..., None].to(xh.dtype)
    da = dt * a  # (B,S,H)

    if state is None:
        y, final_state = _ssd_chunked(xbar, da.to(xh.dtype), b_, c_, chunk)
    else:
        # Single-step recurrence: state ← state·exp(dA) + B ⊗ xbar; y = C·state.
        dec = torch.exp(da[:, 0]).to(state.dtype)  # (B,H)
        outer = _einsum("bhp,bn->bhpn", xbar[:, 0], b_[:, 0]).to(state.dtype)
        final_state = state * dec[:, :, None, None] + outer
        y = _einsum("bn,bhpn->bhp", c_[:, 0], final_state)[:, None].reshape(b, 1, h, pdim)

    y = y.to(x.dtype) + xh * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, di)
    y = y * _silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = _einsum("bsk,kd->bsd", y, p["out_proj"]).to(x.dtype)
    return out, (final_state, new_conv_state)
