"""Roofline terms of a step: compute, memory and collective time per card.

  compute  = FLOPs (per card) / peak FLOP/s
  memory   = HBM bytes (per card) / HBM rate
  collect. = collective bytes (per card) / link rate

The counterpart of ``repro.launch.roofline``, line for line, with the
constants of one NVIDIA H100. The HLO parsers (``shape_bytes``,
``collective_bytes``) read the reference's dry-run text; the port's dry run
(``launch/dryrun.py``) takes the analytic terms (``analytic_costs``,
``model_flops``).
"""
from __future__ import annotations

import dataclasses
import re

# Each constant: NVIDIA data sheet, H100 SXM; the card reads H100 80GB HBM3 at 700 W.
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s (NVIDIA data sheet, H100 SXM)
HBM_BW = 3.35e12  # HBM3 bytes/s (NVIDIA data sheet, H100 SXM)
LINK_BW = 450e9  # NVLink bytes/s one way, 900 GB/s both ways (NVIDIA data sheet, H100 SXM)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def shape_bytes(shape_str: str) -> int:
    """Sum bytes of every typed shape appearing in the string (handles tuples)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_computations(hlo_text: str) -> dict:
    """computation name -> list of instruction lines.

    Computation headers sit at column 0: ``%name (args…) -> ret {`` (args may
    contain nested parens for tuple types, so match only the name prefix).
    """
    comps: dict[str, list] = {}
    cur = None
    for line in hlo_text.splitlines():
        s = line.rstrip()
        if s and not s.startswith(" ") and s.endswith("{"):
            m = re.match(r"^(?:ENTRY\s+)?%([\w\.\-]+)\s*\(", s)
            if m:
                cur = m.group(1)
                comps[cur] = []
                continue
        if cur is not None:
            if s.strip() == "}" and not s.startswith("  "):
                cur = None
            else:
                comps[cur].append(s.strip())
    return comps


_TRIP_RE = re.compile(r"compare\([^)]*\).*direction=LT")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _trip_count(cond_lines: list) -> int:
    """Scan-lowered while conditions compare a counter to a constant bound.
    Take the largest plausible (≤10^6) integer constant in the condition."""
    bound = None
    for ln in cond_lines:
        if "constant(" in ln:
            m = _CONST_RE.search(ln)
            if m and int(m.group(1)) <= 1_000_000:
                bound = max(bound or 0, int(m.group(1)))
    return bound if bound else 1


def collective_bytes(hlo_text: str) -> dict:
    """Per-collective-kind result bytes per chip, *weighted by loop trip
    counts* (XLA HLO text nests scan bodies as named computations that run
    trip-count times; a flat line count would undercount by ~num_layers)."""
    comps = _split_computations(hlo_text)
    op_re = re.compile(r"\b(" + "|".join(_COLLECTIVES) + r")(-start|-done)?\(")
    while_re = re.compile(r"while\(.*\).*condition=%?([\w\.\-]+),.*body=%?([\w\.\-]+)")

    def direct(comp: str) -> dict:
        out = {k: 0 for k in _COLLECTIVES}
        counts = {k: 0 for k in _COLLECTIVES}
        for ls in comps.get(comp, ()):
            if "=" not in ls:
                continue
            _, rhs = ls.split("=", 1)
            m = op_re.search(rhs)
            if not m:
                continue
            op, suffix = m.group(1), m.group(2)
            if suffix == "-done":
                continue
            out[op] += shape_bytes(rhs[: m.start()])
            counts[op] += 1
        return out, counts

    memo: dict[str, dict] = {}

    def total(comp: str, depth=0) -> dict:
        if comp in memo:
            return memo[comp]
        if depth > 20:
            return {k: 0 for k in _COLLECTIVES}
        out, _ = direct(comp)
        for ls in comps.get(comp, ()):
            wm = while_re.search(ls)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                trips = _trip_count(comps.get(cond, []))
                sub = total(body, depth + 1)
                for k in _COLLECTIVES:
                    out[k] += trips * sub[k]
                continue
            # calls / conditionals: count called computations once
            cm = re.search(r"(?:calls|branch_computations)=[{]?%?([\w\.\-,% ]+)", ls)
            if cm and "fusion" not in ls:
                for callee in re.findall(r"%?([\w\.\-]+)", cm.group(1)):
                    if callee in comps and callee != comp:
                        sub = total(callee, depth + 1)
                        for k in _COLLECTIVES:
                            out[k] += sub[k]
        memo[comp] = out
        return out

    entry = None
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            m = re.match(r"ENTRY\s+%?([\w\.\-]+)", line)
            if m:
                entry = m.group(1)
            break
    agg = total(entry) if entry else {k: 0 for k in _COLLECTIVES}
    _, entry_counts = direct(entry) if entry else ({}, {k: 0 for k in _COLLECTIVES})
    agg["total"] = sum(agg[k] for k in _COLLECTIVES)
    agg["counts"] = entry_counts
    return agg


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    chips: int
    model_flops_global: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs × chips) — fraction of compiled compute
        that is 'useful' model math (catches remat/redundancy waste)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Model FLOPs / (chips × peak × step-time lower bound)."""
        denom = self.chips * PEAK_FLOPS * self.step_time_lower_bound
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_upper_bound": self.mfu_upper_bound,
        }


def _attn_context(cfg, s: int) -> float:
    """Mean effective context length per query across layers (windowed layers
    attend to ≤ window tokens; causal global layers to s/2 on average)."""
    total = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.block_kind(i)
        if kind == "m":
            total += 0.0
            continue
        w = cfg.window if (kind == "l" and cfg.window) else None
        if kind == "h" and cfg.window:
            w = cfg.window if cfg.layer_pattern[i % len(cfg.layer_pattern)] == "l" else None
        total += min(w, s) if w else s / 2.0
    return total / max(cfg.num_layers, 1)


def analytic_costs(cfg, shape, chips: int, *, microbatches: int = 1, model_shards: int = 16,
                   param_bytes: int = 2) -> dict:
    """Structural FLOP/byte model (trip-count exact, as the reference's).

    FLOPs: matmul-dominated 2·N·token (+attention 4·B·H·hd·S·ctx per layer
    fwd), train = fwd + remat-fwd + 2×bwd = 4× fwd. Bytes: parameter +
    optimizer + activation + cache traffic with documented coefficients.
    """
    s = shape.seq_len
    b = shape.global_batch
    n_act = cfg.active_param_count()
    n_tot = cfg.param_count()
    l = cfg.num_layers
    d = cfg.d_model

    is_attn = cfg.family != "ssm"
    ctx = _attn_context(cfg, s)
    hq_hd = cfg.num_heads * cfg.head_dim

    if shape.kind == "train":
        tokens = b * s
        fwd = 2.0 * n_act * tokens + (4.0 * tokens * hq_hd * ctx * l if is_attn else 0.0)
        # SSD flops (mamba/hybrid): ~2·(intra-chunk + state) per token.
        if cfg.ssm_state:
            fwd += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * l
        flops = 4.0 * fwd  # fwd + remat-fwd + 2×bwd
    elif shape.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_act * tokens + (4.0 * tokens * hq_hd * ctx * l if is_attn else 0.0)
        if cfg.ssm_state:
            flops += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * l
    else:  # decode: one token per sequence
        tokens = b
        ctx_dec = 0.0
        for i in range(l):
            kind = cfg.block_kind(i)
            if kind == "m":
                continue
            w = cfg.window if (kind == "l" and cfg.window) else None
            ctx_dec += min(w, s) if w else s
        flops = 2.0 * n_act * tokens + 4.0 * tokens * hq_hd * ctx_dec
        if cfg.ssm_state:
            flops += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * l

    flops_per_chip = flops / chips

    # --- HBM traffic per chip ---
    p_local = n_tot * param_bytes / model_shards  # params replicated over data
    data_shards = max(chips // model_shards, 1)
    if shape.kind == "train":
        opt_local = n_tot * 8 / chips  # ZeRO-1 f32 moments over all chips
        grad_local = n_tot * 4 / model_shards
        tokens_local = b * s / data_shards
        # params: read fwd + remat + bwd; grads: write+read; opt: m,v r/w + p write
        param_traffic = 3 * p_local + 3 * grad_local + 5 * opt_local
        act_traffic = tokens_local * d * 2 * l * 6  # ~6 tensor r/w per layer, bf16
        bytes_per_chip = param_traffic + act_traffic
    elif shape.kind == "prefill":
        tokens_local = b * s / data_shards
        bytes_per_chip = p_local + tokens_local * d * 2 * l * 4
        cache_local = l * b * cfg.num_kv_heads * s * cfg.head_dim * 2 * 2 / chips
        bytes_per_chip += cache_local
    else:
        cache_local = l * b * cfg.num_kv_heads * s * cfg.head_dim * 2 * 2 / chips
        state_local = (
            l * b * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state + 3 * (cfg.d_inner))
            * 4 / max(data_shards, 1) if cfg.ssm_state else 0.0
        )
        bytes_per_chip = p_local + cache_local + state_local
    return {"flops_per_chip": flops_per_chip, "hbm_bytes_per_chip": bytes_per_chip}


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs: 6·N·D train / 2·N·D forward (MoE: N_active) plus a
    *window-aware* attention term (same context accounting as analytic_costs,
    so the useful-FLOPs ratio isolates remat/redundancy waste — 0.75 for
    full-remat training, 1.0 for inference — rather than window effects)."""
    n = cfg.active_param_count()
    s = shape.seq_len
    l = cfg.num_layers
    hq_hd = cfg.num_heads * cfg.head_dim
    is_attn = cfg.family != "ssm"
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * s
        ctx = _attn_context(cfg, s)
        fwd = 2.0 * n * tokens + (4.0 * tokens * hq_hd * ctx * l if is_attn else 0.0)
        if cfg.ssm_state:
            fwd += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * l
        return 3.0 * fwd if shape.kind == "train" else fwd
    tokens = shape.global_batch
    ctx_dec = 0.0
    for i in range(l):
        kind = cfg.block_kind(i)
        if kind == "m":
            continue
        w = cfg.window if (kind == "l" and cfg.window) else None
        ctx_dec += min(w, s) if w else s
    fwd = 2.0 * n * tokens + 4.0 * tokens * hq_hd * ctx_dec
    if cfg.ssm_state:
        fwd += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * l
    return fwd
