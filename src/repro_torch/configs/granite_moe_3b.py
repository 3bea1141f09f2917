"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_ff 512 per expert.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    num_experts=40, num_shared_experts=0, experts_per_token=8, moe_d_ff=512,
    num_experts_alloc=48,  # padded to a multiple of TP16; pads carry no traffic
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
    d_ff=64, vocab_size=512, num_experts=8, experts_per_token=2, moe_d_ff=32, capacity_factor=8.0,
    num_experts_alloc=None,
)
