"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer; SWA with
three global layers (first/middle/last). [arXiv:2411.13676; hf]"""
import dataclasses
from ..models.config import ModelConfig

_PATTERN = tuple(
    "g" if i in (0, 15, 31) else "l" for i in range(32)
)

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    layer_pattern=_PATTERN, window=1024,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window=32, ssm_state=8, ssm_head_dim=16,
    layer_pattern=("g", "l", "l"),
)
