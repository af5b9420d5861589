"""Gemma2-9B — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2_9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, d_head=256,
    attn_softcap=50.0, final_softcap=30.0,
    window=4096, local_global_pattern=True,
    mlp_activation="gelu", scale_embeddings=True,
    skip_shapes=("long_500k",),  # global layers are full attention
)
