"""gemma3-4b [dense] — 5:1 local:global sliding-window, 128k context, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    layer_pattern=("l", "l", "l", "l", "l", "g"),  # 5 local : 1 global
    window=1024, rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window=32,
)
