"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096.
SWA bounds the decode cache => runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    swa_window=4096,
    mlp_act="swiglu",
    notes="SWA dense (H2O Danube3); head_dim=120",
)
