"""qwen2-1.5b [dense] — GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
    d_ff=96, vocab_size=512,
)
