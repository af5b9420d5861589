"""Whisper-small — enc-dec audio backbone; conv frontend stubbed
[arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper_small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, d_head=64,
    n_enc_layers=12, enc_seq=1500,  # precomputed frame embeddings (stub)
    mlp_activation="gelu", mlp_gated=False, pos_embedding="learned",
    skip_shapes=("long_500k",),  # full attention decoder
)
