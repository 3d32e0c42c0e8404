"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP.  [arXiv:2402.16819; unverified]

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mlp_act="sq_relu",
    notes="squared-ReLU dense MLP (Nemotron-4)",
)
