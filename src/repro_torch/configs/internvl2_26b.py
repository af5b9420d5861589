"""InternVL2-26B — InternViT frontend (stub) + InternLM2-20B backbone
[arXiv:2404.16821; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, d_head=128,
    n_frontend_tokens=256,  # precomputed patch embeddings (input_specs stub)
    tie_embeddings=False,
    skip_shapes=("long_500k",),  # full attention
)
