"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6 fine-grained experts.
[arXiv:2401.06066; hf]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    num_experts=64, num_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=512, num_experts=8, experts_per_token=2, moe_d_ff=64, capacity_factor=8.0,
)
