"""Zamba2-1.2B — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; hf]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="zamba2_1p2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, d_head=64,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    hybrid_attn_every=6,  # shared attention+MLP block applied every 6 layers
    window=4096,          # shared attn uses sliding window in long mode
)
