"""Unified causal LM covering all assigned families, in PyTorch.

The counterpart of ``repro.models.model``. The reference keeps one parameter
pytree with layer-stacked leaves and scans over the layer axis; here a
``CausalLM`` holds an ``nn.ModuleList`` of blocks, one a layer, each with
that layer's slice of every stacked leaf under the leaf's own name
(``model.layers[i].wq`` is the reference's ``params["layers"]["wq"][i]``).
Every module can be read as that dict (``p["wq"]``), so the layer functions
take either. Families:

  dense / vlm / audio-backbone : attention + (Sw)iGLU MLP
  moe                          : attention + routed experts (+ shared)
  ssm                          : Mamba2 SSD blocks only
  hybrid                       : parallel attention+SSD heads (Hymba) + MLP
  encdec                       : whisper — bidirectional encoder + causal
                                 decoder with cross-attention

Positional encoding is unified to RoPE (DESIGN.md §8). Serving runs under
``torch.inference_mode()``; the cache is updated in place and its ``"pos"``
is a Python int, so a decode step reads nothing back from the device.
``param_shapes``, ``params_from_numpy`` and ``params_to_numpy`` carry the
reference's stacked parameters across as numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..compat import resolve_device
from . import dist as _dist
from . import layers
from .config import ModelConfig

# Leaves the reference initialises to zeros (norm scales are 1 + w) or ones;
# every other leaf is drawn from N(0, 1) times its scale.
_ZEROS = {"bq", "bk", "bv", "q_norm", "k_norm", "a_log", "dt_bias", "out_norm", "final_norm", "enc_final_norm",
          "ln1", "ln2", "ln_cross", "fuse_attn", "fuse_ssm"}
_ONES = {"d_skip"}
_OUT = {"wo", "w2", "out_proj"}  # output projections: 0.02 / sqrt(2 L)
_STACKED = ("layers", "encoder")  # subtrees whose leaves carry a leading layer axis


# ------------------------------------------------------------ parameter tree
def param_shapes(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """The reference's ``init_params(cfg, key, dtype)`` tree as nested dicts
    of ``(shape, torch dtype)`` leaves, stacked leaves with the layer axis
    first. The router, ``a_log`` and ``dt_bias`` are float32 at any dtype."""
    d, l = cfg.d_model, cfg.num_layers
    f32 = torch.float32

    def attn_params(nl):
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        p = {
            "wq": ((nl, d, nh, hd), dtype),
            "wk": ((nl, d, nkv, hd), dtype),
            "wv": ((nl, d, nkv, hd), dtype),
            "wo": ((nl, nh, hd, d), dtype),
        }
        if cfg.qkv_bias:
            p["bq"] = ((nl, nh, hd), dtype)
            p["bk"] = ((nl, nkv, hd), dtype)
            p["bv"] = ((nl, nkv, hd), dtype)
        if cfg.qk_norm:
            p["q_norm"] = ((nl, hd), dtype)
            p["k_norm"] = ((nl, hd), dtype)
        return p

    def mlp_params(nl, width):
        p = {"w1": ((nl, d, width), dtype), "w2": ((nl, width, d), dtype)}
        if cfg.act != "gelu":
            p["w3"] = ((nl, d, width), dtype)
        return p

    def ssm_params(nl):
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return {
            "in_proj": ((nl, d, 2 * di + 2 * n + h), dtype),
            "conv_w": ((nl, cfg.ssm_conv, di + 2 * n), dtype),
            "a_log": ((nl, h), f32),
            "dt_bias": ((nl, h), f32),
            "d_skip": ((nl, h), dtype),
            "out_norm": ((nl, di), dtype),
            "out_proj": ((nl, di, d), dtype),
        }

    params: dict = {"embed": ((cfg.vocab_size, d), dtype), "final_norm": ((d,), dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ((d, cfg.vocab_size), dtype)

    lay: dict = {"ln1": ((l, d), dtype)}
    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        lay.update(attn_params(l))
        lay["ln2"] = ((l, d), dtype)
        lay.update(mlp_params(l, cfg.d_ff))
    elif fam == "moe":
        lay.update(attn_params(l))
        lay["ln2"] = ((l, d), dtype)
        e, f = cfg.experts_alloc, cfg.moe_d_ff
        lay["router"] = ((l, d, e), f32)
        lay["w1"] = ((l, e, d, f), dtype)
        lay["w3"] = ((l, e, d, f), dtype)
        lay["w2"] = ((l, e, f, d), dtype)
        if cfg.num_shared_experts:
            sw = f * cfg.num_shared_experts
            lay["shared"] = {"w1": ((l, d, sw), dtype), "w3": ((l, d, sw), dtype), "w2": ((l, sw, d), dtype)}
    elif fam == "ssm":
        lay.update(ssm_params(l))
    elif fam == "hybrid":
        lay.update(attn_params(l))
        lay["ssm"] = ssm_params(l)
        lay["fuse_attn"] = ((l, d), dtype)
        lay["fuse_ssm"] = ((l, d), dtype)
        lay["ln2"] = ((l, d), dtype)
        lay.update(mlp_params(l, cfg.d_ff))
    elif fam == "encdec":
        lay.update(attn_params(l))
        lay["ln_cross"] = ((l, d), dtype)
        lay["cross"] = attn_params(l)
        lay["ln2"] = ((l, d), dtype)
        lay.update(mlp_params(l, cfg.d_ff))
        el = cfg.encoder_layers
        enc = {"ln1": ((el, d), dtype), "ln2": ((el, d), dtype)}
        enc.update(attn_params(el))
        enc.update(mlp_params(el, cfg.d_ff))
        params["encoder"] = enc
        params["enc_final_norm"] = ((d,), dtype)
    else:
        raise ValueError(fam)
    params["layers"] = lay
    return params


def _leaves(tree: dict, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _unstack(tree: dict) -> dict:
    """One layer's shapes: the leading layer axis dropped from every leaf."""
    return {k: _unstack(v) if isinstance(v, dict) else (v[0][1:], v[1]) for k, v in tree.items()}


class Params(nn.Module):
    """A dict of parameters and nested dicts, built from a ``param_shapes``
    subtree and read as ``p[name]`` (``get`` and ``in`` as on a dict)."""

    def __init__(self, shapes: dict, device):
        super().__init__()
        for name, leaf in shapes.items():
            if isinstance(leaf, dict):
                self.add_module(name, Params(leaf, device))
            else:
                shape, dt = leaf
                self.register_parameter(name, nn.Parameter(torch.empty(shape, dtype=dt, device=device)))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name, default=None):
        return self[name] if name in self else default


class CausalLM(Params):
    """The model: ``embed``, ``final_norm`` (and ``lm_head`` when untied),
    ``layers`` (one block of the family's parameters a layer) and, for
    encdec, ``encoder`` and ``enc_final_norm``. Parameters are allocated,
    not initialised: build one with ``init_params`` or ``params_from_numpy``,
    and run it through the forward functions below."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        shapes = param_shapes(cfg, dtype)
        super().__init__({k: v for k, v in shapes.items() if k not in _STACKED}, dev)
        self.cfg = cfg
        for name, depth in (("layers", cfg.num_layers), ("encoder", cfg.encoder_layers)):
            if name in shapes:
                one = _unstack(shapes[name])
                self.add_module(name, nn.ModuleList(Params(one, dev) for _ in range(depth)))


# ---------------------------------------------------------------- param init
def init_params(cfg: ModelConfig, *, generator: torch.Generator, dtype=torch.float32, device=None) -> CausalLM:
    """A ``CausalLM`` with the reference's initialisation: N(0, 0.02²) for
    projections and embeddings (output projections 0.02 / sqrt(2 L), the
    SSD's ``conv_w`` 0.2), drawn in float32 and cast; zeros for norms, biases,
    ``a_log`` and ``dt_bias``; ones for ``d_skip``. Every draw is made on the
    device from ``generator`` (a generator of that device)."""
    model = CausalLM(cfg, dtype=dtype, device=device)
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZEROS:
                prm.zero_()
            elif leaf in _ONES:
                prm.fill_(1.0)
            else:
                scale = out_scale if leaf in _OUT else 0.2 if leaf == "conv_w" else 0.02
                draw = torch.randn(prm.shape, generator=generator, dtype=torch.float32, device=prm.device)
                prm.copy_(draw.mul_(scale))
                del draw
    return model


def _param(root: Params, path: tuple) -> torch.Tensor:
    for name in path:
        root = root[name]
    return root


def params_from_numpy(cfg: ModelConfig, tree: dict, *, dtype=torch.float32, device=None) -> CausalLM:
    """A ``CausalLM`` holding the reference's stacked parameters ``tree``
    (nested dicts of numpy arrays, as ``init_params`` returns them), each cast
    to its ``param_shapes(cfg, dtype)`` dtype."""
    model = CausalLM(cfg, dtype=dtype, device=device)
    want = dict(_leaves(param_shapes(cfg, dtype)))
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"the tree's leaves differ from param_shapes: missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}")
    with torch.no_grad():
        for path, (shape, _) in want.items():
            arr = np.asarray(got[path])
            if arr.shape != tuple(shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, expected {tuple(shape)}")
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if path[0] in _STACKED:
                for i, blk in enumerate(model[path[0]]):
                    _param(blk, path[1:]).copy_(t[i])
            else:
                _param(model, path).copy_(t)
    return model


def params_to_numpy(model: CausalLM) -> dict:
    """The inverse of ``params_from_numpy``: the reference's stacked tree as
    numpy arrays (bfloat16 leaves come back as float32), each a copy that a
    later update of the model leaves as it is."""
    out: dict = {}
    for path, _ in _leaves(param_shapes(model.cfg)):
        if path[0] in _STACKED:
            t = torch.stack([_param(blk, path[1:]).detach() for blk in model[path[0]]])
        else:
            t = _param(model, path).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = t.to("cpu", copy=True).numpy()
    return out


# ------------------------------------------------------------------ caches
def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32) -> dict:
    """The reference's ``init_cache(cfg, batch, max_len, dtype)`` as
    ``(shape, dtype)`` leaves (``"pos"`` a 0-d int32), allocating nothing."""
    l = cfg.num_layers
    shapes: dict = {"pos": ((), torch.int32)}
    fam = cfg.family
    if fam in ("dense", "vlm", "audio", "moe", "hybrid", "encdec"):
        shapes["k"] = shapes["v"] = ((l, batch, cfg.num_kv_heads, max_len, cfg.head_dim), dtype)
    if fam == "encdec":
        shapes["cross_k"] = shapes["cross_v"] = ((l, batch, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim), dtype)
    if fam in ("ssm", "hybrid"):
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        shapes["ssm_state"] = ((l, batch, h, cfg.ssm_head_dim, n), dtype)
        shapes["conv_state"] = ((l, batch, cfg.ssm_conv - 1, di + 2 * n), dtype)
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.float32, device=None, dist=None) -> dict:
    """The reference's cache: layer-stacked tensors and ``"pos"``, here a
    Python int. The forward functions update it in place.

    ``batch`` and ``max_len`` are global. Under ``dist`` (default: the live
    distribution, ``models.dist.current()``) the cache is this rank's share,
    as the reference's ``cache_spec`` lays it out: the rows of its batch index
    (``Distribution.batch_rows``), and of K/V the slice of its sequence index
    (``seq_slice``). The SSM states and encdec's cross K/V keep every position
    of the rank's rows."""
    dev = resolve_device(device)
    dist = _dist.current() if dist is None else dist
    rows = seq = None
    if dist is not None:
        lo, hi = dist.batch_rows(batch) if dist.batch_axes else (0, batch)
        rows = hi - lo
        lo, hi = dist.seq_slice(max_len) if dist.seq_axes else (0, max_len)
        seq = hi - lo
    cache: dict = {"pos": 0}
    for key, (shape, dt) in cache_shapes(cfg, batch, max_len, dtype).items():
        if key == "pos":
            continue
        if rows is not None:
            shape = (shape[0], rows, *shape[2:])
            if key in ("k", "v"):
                shape = (*shape[:3], seq, shape[4])
        cache[key] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


# -------------------------------------------------------------- layer stacks
def _block(cfg: ModelConfig, p, x, window: int, *, q_offset: int, cache_l, kv_len, enc_out=None):
    """One decoder block. cache_l: this layer's views of the cache or None.
    Returns (x, aux, new_cache): the leaves this layer writes."""
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    attn_cache = None
    if cache_l is not None and "k" in cache_l:
        attn_cache = {"k": cache_l["k"], "v": cache_l["v"], "pos": q_offset}
    # SSD runs its O(1) recurrence only for single-token decode; any longer
    # sequence (train or prefill) goes through the chunked scan from state 0.
    is_decode = x.shape[1] == 1 and cache_l is not None

    def ssm_io():
        if is_decode:
            return cache_l.get("ssm_state"), cache_l.get("conv_state")
        return None, None

    if fam in ("dense", "vlm", "audio", "moe", "encdec"):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn, ac = layers.attention_block(
            p, h, cfg, window=window, q_offset=q_offset, cache=attn_cache, kv_len=kv_len
        )
        x = x + attn
        if ac is not None:
            new_cache.update(ac)
        if fam == "encdec":
            if enc_out is not None:
                ck = layers._einsum("bsd,dhk->bhsk", enc_out, p["cross"]["wk"])
                cv = layers._einsum("bsd,dhk->bhsk", enc_out, p["cross"]["wv"])
            else:  # decode: from the cache (filled at prefill)
                ck, cv = cache_l["cross_k"], cache_l["cross_v"]
            h = layers.rms_norm(x, p["ln_cross"], cfg.norm_eps)
            x = x + layers.cross_attention_block(p["cross"], h, (ck, cv), cfg)
            if cache_l is not None:
                new_cache["cross_k"], new_cache["cross_v"] = ck, cv
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        if fam == "moe":
            y, aux = layers.moe_block(p, h, cfg)
        else:
            y = layers.mlp_block(p, h, cfg.act)
        x = x + y
    elif fam == "ssm":
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        st, cv = ssm_io()
        y, (st2, cv2) = layers.ssd_block(p, h, cfg, state=st, conv_state=cv)
        x = x + y
        if cache_l is not None:
            new_cache["ssm_state"], new_cache["conv_state"] = st2, cv2
    elif fam == "hybrid":
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn, ac = layers.attention_block(
            p, h, cfg, window=window, q_offset=q_offset, cache=attn_cache, kv_len=kv_len
        )
        st, cv = ssm_io()
        ssm_y, (st2, cv2) = layers.ssd_block(p["ssm"], h, cfg, state=st, conv_state=cv)
        fused = 0.5 * (
            layers.rms_norm(attn, p["fuse_attn"], cfg.norm_eps)
            + layers.rms_norm(ssm_y, p["fuse_ssm"], cfg.norm_eps)
        )
        x = x + fused
        if cache_l is not None:
            if ac is not None:
                new_cache.update(ac)
            new_cache["ssm_state"], new_cache["conv_state"] = st2, cv2
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + layers.mlp_block(p, h, cfg.act)
    else:
        raise ValueError(fam)
    return x, aux, new_cache


def _run_layers(cfg, model, x, *, q_offset: int = 0, caches=None, kv_len=None, enc_out=None, remat: bool = True):
    """Every decoder layer in turn, each writing its leaves of ``caches`` in
    place. Returns (x, aux). With ``remat`` (training without caches) each
    layer's body is a remat site: backward recomputes it from its input."""
    windows = [w or 0 for w in cfg.layer_windows()]
    if caches is not None and x.shape[1] == 1:
        enc_out = None  # decode: encdec's cross K/V come from the cache
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, enc_out, blk, window):
        return _block(cfg, blk, x, window, q_offset=q_offset, cache_l=None, kv_len=kv_len, enc_out=enc_out)[:2]

    for i, blk in enumerate(model["layers"]):
        if caches is None:
            args = (x, enc_out, blk, windows[i])
            x, aux_l = layers.remat(body, *args) if remat else body(*args)
        else:
            cache_l = {k: v[i] for k, v in caches.items() if k != "pos"}
            x, aux_l, new_cache = _block(cfg, blk, x, windows[i], q_offset=q_offset, cache_l=cache_l, kv_len=kv_len,
                                         enc_out=enc_out)
            for key, new in new_cache.items():
                if new is not cache_l[key]:  # the attention K/V were written in place
                    cache_l[key].copy_(new)
        aux = aux + aux_l
    return x, aux


# ------------------------------------------------------------------- embed/loss
def _embed(cfg, params, tokens, batch_extras):
    x = params["embed"][tokens]
    if cfg.family == "vlm" and batch_extras.get("patch_embeds") is not None:
        pe = batch_extras["patch_embeds"].to(x.dtype)
        npatch = pe.shape[1]
        x = torch.cat([pe, x[:, npatch:]], dim=1)
    return x


def _encode(cfg, params, frames):
    """Whisper encoder over stub frame embeddings (B, Se, D): non-causal,
    every window 0 (global). Each layer's body is a remat site."""

    def body(x, p):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn, _ = layers.attention_block(p, h, cfg, window=0, causal=False)
        x = x + attn
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + layers.mlp_block(p, h, cfg.act)

    x = frames
    for p in params["encoder"]:
        x = layers.remat(body, x, p)
    return layers.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def chunked_ce_loss(x, embed, targets, mask=None, *, chunk: int = 512, softcap=None, lm_head=None):
    """Cross-entropy with sequence-chunked logits (never materializes
    (B, S, V) f32). x: (B,S,D); embed: (V,D) (tied) or lm_head (D,V). Each
    chunk is a remat site: backward recomputes its (B, c, V) float32 logits
    instead of keeping every chunk's."""
    b, s, d = x.shape
    c = min(chunk, s)
    while s % c:
        c //= 2
    w = (embed.T if lm_head is None else lm_head).float()  # (D, V)

    def step(xc, w, tc):
        logits = torch.matmul(xc.float(), w)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        return lse - gold

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i0 in range(0, s, c):
        nll = layers.remat(step, x[:, i0 : i0 + c], w, targets[:, i0 : i0 + c])
        if mask is not None:
            mc = mask[:, i0 : i0 + c]
            tot = tot + (nll * mc).sum()
            cnt = cnt + mc.sum()
        else:
            tot = tot + nll.sum()
            cnt = cnt + b * c
    return tot / torch.clamp_min(cnt, 1.0)


# ----------------------------------------------------------------- public API
def forward_train(params, cfg: ModelConfig, batch: dict, *, remat: bool = True):
    """batch: tokens (B,S) int, targets (B,S) int, optional patch_embeds /
    frames. Returns (loss + 0.01 · aux, {"ce_loss", "aux_loss"}); a caller
    that trains takes the loss's gradient. ``remat`` makes each layer's body
    a remat site; the encoder's bodies, the attention's query slices, the SSD
    chunks and the loss's chunks are remat sites always. With gradients off
    every site is a direct call."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens, batch)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(cfg, params, batch["frames"])
    x, aux = _run_layers(cfg, params, x, enc_out=enc_out, remat=remat)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = chunked_ce_loss(
        x, params["embed"], batch["targets"],
        softcap=cfg.final_softcap, lm_head=params.get("lm_head"),
    )
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss, "aux_loss": aux}


def forward_prefill(params, cfg: ModelConfig, batch: dict, cache: dict):
    """Run the prompt through the model, filling ``cache`` in place from
    position 0. Returns (last-position logits (B, V) f32, the cache). Under a
    distribution the batch is this rank's rows and the cache its share
    (``init_cache``): each rank attends over the whole prompt of its rows and
    keeps its slice of the K/V."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, params, tokens, batch)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(cfg, params, batch["frames"])
    x, _ = _run_layers(cfg, params, x, q_offset=0, caches=cache, enc_out=enc_out)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _final_logits(params, cfg, x[:, -1:])
    cache["pos"] = s
    return logits[:, 0], cache


def forward_decode(params, cfg: ModelConfig, token, cache: dict, batch_extras: Optional[dict] = None):
    """One decode step. token: (B, 1) int. Updates ``cache`` in place.
    Returns (logits (B, V) f32, the cache). Under a distribution with
    ``sp_decode`` the token is this rank's rows and attention runs over the
    ranks' cache slices (``models.dist.sp_decode_attention``)."""
    x = params["embed"][token]
    # encdec: cross K/V comes from the cache (filled at prefill) — the
    # encoder is NOT re-run per decode step.
    x, _ = _run_layers(cfg, params, x, q_offset=cache["pos"], caches=cache)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _final_logits(params, cfg, x)
    cache["pos"] += 1
    return logits[:, 0], cache


def _final_logits(params, cfg, x):
    w = params.get("lm_head")
    w = params["embed"].T if w is None else w
    logits = torch.matmul(x.float(), w.float())
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
