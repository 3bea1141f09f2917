"""Unified model configuration for the 10 assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention flavor ---
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2 attention-logit soft cap
    final_softcap: Optional[float] = None  # gemma2 final-logit soft cap
    window: Optional[int] = None  # sliding-window size for "local" layers
    layer_pattern: tuple = ("g",)  # cycled: g=global, l=local(window), m=mamba, h=hybrid
    rope_theta: float = 10_000.0
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # Allocated expert count (≥ num_experts). Set to the next multiple of the
    # TP degree when num_experts doesn't divide it (e.g. granite 40→48);
    # padded experts get −inf router logits and carry no traffic.
    num_experts_alloc: Optional[int] = None
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed frame count from the audio frontend stub
    # --- modality stubs ---
    num_patches: int = 0  # vlm: prefix positions fed by the vision stub
    act: str = "silu"
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def experts_alloc(self) -> int:
        return self.num_experts_alloc or self.num_experts

    @property
    def d_inner(self) -> int:  # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def block_kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def layer_windows(self) -> list:
        """Per-layer sliding window (None ⇒ global) for attention layers."""
        out = []
        for i in range(self.num_layers):
            out.append(self.window if self.block_kind(i) == "l" else None)
        return out

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline."""
        d, l = self.d_model, self.num_layers
        n = self.vocab_size * d  # embed (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if self.num_experts:
            ff = 3 * d * self.moe_d_ff * (self.num_experts + self.num_shared_experts) + d * self.num_experts
        else:
            ff = 3 * d * self.d_ff if self.d_ff else 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * ns + nh) + di * d + self.ssm_conv * di
        # Block composition is set by FAMILY (layer_pattern only selects the
        # attention window, e.g. hymba's pattern is g/l yet every layer is
        # a hybrid attn+SSD block).
        if self.family == "ssm":
            per_layer = 2 * d + ssm
        elif self.family == "hybrid":
            per_layer = 2 * d + attn + ssm + ff
        else:
            per_layer = 2 * d + attn + ff
        n += l * per_layer
        if self.encoder_layers:
            n += self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
            n += l * (attn + d)  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_ff = 3 * d * self.moe_d_ff * self.num_experts
        act_ff = 3 * d * self.moe_d_ff * self.experts_per_token
        return full - self.num_layers * (all_ff - act_ff)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch runs these four cells unless skipped.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic / windowed / SSM decode).
LONG_CONTEXT_OK = {"gemma3-4b", "mamba2-1.3b", "hymba-1.5b"}


def cell_is_runnable(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_OK
    return True
