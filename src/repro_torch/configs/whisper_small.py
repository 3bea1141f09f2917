"""whisper-small [audio] — enc-dec backbone; conv/audio frontend is a stub
providing 1500 precomputed frame embeddings. [arXiv:2212.04356; unverified]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1536, act="gelu", tie_embeddings=True,
    # 1500 mel frames padded to 1536 by the audio stub: 1500 forces 4-wide
    # attention kv-blocks (375-trip scans); 1536 = 3×512 tiles cleanly.
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, encoder_layers=2, encoder_seq=24,
)
