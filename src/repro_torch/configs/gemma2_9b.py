"""gemma2-9b [dense] — alternating local(4096)/global, logit softcaps.
[arXiv:2408.00118; hf]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    layer_pattern=("l", "g"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window=32,
)
