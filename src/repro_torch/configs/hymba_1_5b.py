"""hymba-1.5b [hybrid] — per-layer parallel attention + mamba heads.

[arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
SWA(1024) attention branch + mamba branch, learnably gated fusion.
Q-heads padded 25->32, KV 5->16; vocab padded 32001->32016 for TP=16.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    swa_window=1024,
    mlp_act="swiglu",
    notes="parallel attn+mamba heads (Hymba); head_dim=64",
)
