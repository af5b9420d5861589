"""ChatGLM3-6B — 2d (half-dim) RoPE, GQA kv=2 [arXiv:2406.12793; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="chatglm3_6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, d_head=128, rope_fraction=0.5,
    tie_embeddings=False,
    skip_shapes=("long_500k",),  # full attention
)
