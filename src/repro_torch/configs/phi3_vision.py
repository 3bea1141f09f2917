"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision stub.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    num_patches=576,  # CLIP ViT-L/14 @336: (336/14)^2 patch embeddings (stub)
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, num_patches=8,
)
