"""Mamba2-780M — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2_780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    pos_embedding="none",
)
