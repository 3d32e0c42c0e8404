"""internvl2-76b [vlm] — InternViT + InternLM2 backbone.  [arXiv:2404.16821; unverified]

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The ViT frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings (B, 256, 1024) projected into the backbone.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    frontend="patch",
    frontend_dim=1024,
    n_frontend_tokens=256,
    mlp_act="swiglu",
    notes="LM backbone of InternVL2-Llama3-76B; patch frontend stubbed",
)
