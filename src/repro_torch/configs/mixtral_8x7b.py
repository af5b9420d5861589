"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, d_head=128, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    # SWA => decode KV cache bounded by window; long_500k runs (windowed).
)
