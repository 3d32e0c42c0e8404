"""falcon-mamba-7b [ssm] — pure mamba-1, attention-free.  [arXiv:2410.05355; unverified]

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16.
TP shards the 8192 inner channels (per-channel-independent SSM => clean TP).
Attention-free => bounded decode state => runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    notes="mamba1 arch (Falcon-Mamba)",
)
