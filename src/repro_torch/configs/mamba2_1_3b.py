"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=1, head_dim=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    layer_pattern=("m",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, vocab_size=512, ssm_state=16, ssm_head_dim=16,
)
