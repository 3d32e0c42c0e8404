"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Q-heads padded 56->64 and KV 8->16 for TP=16 (overhead visible in the
MODEL/HLO FLOPs ratio, DESIGN.md §6).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dense_ff=4864,
    mlp_act="swiglu",
    notes="dense-MoE hybrid residual (Snowflake Arctic)",
)
