"""Kimi K2 — trillion-param MoE, 384 experts top-8 (paper-table)
[arXiv:2501.kimi2; unverified]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="kimi_k2_1t_a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, d_head=128,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1),
    tie_embeddings=False,
    skip_shapes=("long_500k",),  # full attention
)
