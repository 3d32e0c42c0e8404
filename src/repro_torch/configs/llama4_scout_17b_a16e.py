"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
Q-heads padded 40->48, KV 8->16 for TP=16.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    mlp_act="swiglu",
    notes="top-1 routed MoE (Llama-4 Scout)",
)
