"""hubert-xlarge [audio] — encoder-only transformer backbone.  [arXiv:2106.07447; unverified]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets).
The conv waveform frontend is a STUB: ``input_specs`` provides precomputed
frame embeddings (B, S, 1280).  Encoder-only => no decode shapes.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    decoder=False,
    frontend="frame",
    frontend_dim=1280,
    mlp_act="gelu",
    notes="encoder-only (HuBERT X-Large); frame frontend stubbed",
)
