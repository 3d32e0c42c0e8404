"""chatglm3-6b [dense] — partial ("2d") RoPE, extreme GQA kv=2.  [arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_variant="partial",
    mlp_act="swiglu",
    notes="partial rotary on half head dims (GLM)",
)
