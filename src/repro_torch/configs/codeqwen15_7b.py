"""CodeQwen1.5-7B — qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="codeqwen15_7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, d_head=128, rope_theta=1_000_000.0,
    tie_embeddings=False,
    skip_shapes=("long_500k",),  # full attention
)
