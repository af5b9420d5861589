"""Config system: architecture configs + input-shape sets + runtime knobs.

Every assigned architecture is a module ``repro_torch.configs.<arch_id>``
exposing ``CONFIG`` (exact paper/HF numbers) and the registry maps
``--arch`` ids to them. ``smoke()`` returns a reduced same-family config
for CPU tests. The port carries every architecture of ``ARCH_IDS``:
the dense ``qwen3_4b``, ``gemma2_9b``, ``chatglm3_6b`` and
``codeqwen15_7b``, the moe ``mixtral_8x7b`` and ``kimi_k2_1t_a32b``, the
ssm ``mamba2_780m``, the hybrid ``zamba2_1p2b``, the audio
encoder-decoder ``whisper_small`` and the vlm ``internvl2_26b``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0  # Kimi-K2/DeepSeek style shared expert(s)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2          # d_inner = expand * d_model
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    # attention variants
    pos_embedding: str = "rope"           # rope | learned | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0            # chatglm "2d" RoPE: 0.5
    qk_norm: bool = False                 # qwen3
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None # gemma2: 30.0
    window: Optional[int] = None          # sliding-window size (SWA)
    local_global_pattern: bool = False    # gemma2: alternate local/global
    attn_logit_scale: Optional[float] = None
    mlp_activation: str = "silu"          # silu (swiglu) | gelu
    mlp_gated: bool = True                # gated (3-matrix) vs plain (2)
    scale_embeddings: bool = False        # gemma2: x *= sqrt(d_model)
    tie_embeddings: bool = True
    # mixtures
    moe: Optional[MoEConfig] = None
    # ssm / hybrid
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0            # zamba2: shared attn block period
    # encoder-decoder (whisper) / frontend stubs (vlm, audio)
    n_enc_layers: int = 0
    enc_seq: int = 0                      # encoder sequence (stub embeddings)
    n_frontend_tokens: int = 0            # vlm: patch tokens prepended
    # norms
    rmsnorm_eps: float = 1e-6
    # which shapes this arch supports (skips documented in DESIGN.md)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def n_params(self) -> int:
        """Total parameter count (embedding + stacked blocks)."""
        D, H, Kv, Dh, F, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.d_ff, self.vocab)
        p = V * D  # embedding (tied output head)
        if not self.tie_embeddings:
            p += V * D
        def attn_params() -> int:
            return D * (H * Dh) + 2 * D * (Kv * Dh) + (H * Dh) * D

        def mlp_params(ff: int) -> int:
            return (3 if self.mlp_gated else 2) * D * ff

        per_layer = 2 * D  # norms
        if self.family == "ssm":
            s = self.ssm
            d_inner = s.expand * D
            nheads = d_inner // s.head_dim
            conv_dim = d_inner + 2 * s.n_groups * s.d_state
            per_layer += (D * (2 * d_inner + 2 * s.n_groups * s.d_state + nheads)
                          + conv_dim * s.d_conv + nheads * 2  # A, D
                          + d_inner * D)
        elif self.family == "hybrid":
            # mamba layers only; the (shared) attention+MLP block is counted
            # once below (zamba2: MLP lives in the shared block, not per layer)
            s = self.ssm
            d_inner = s.expand * D
            nheads = d_inner // s.head_dim
            conv_dim = d_inner + 2 * s.n_groups * s.d_state
            per_layer += (D * (2 * d_inner + 2 * s.n_groups * s.d_state + nheads)
                          + conv_dim * s.d_conv + nheads * 2 + d_inner * D)
        else:
            per_layer += attn_params()
            if self.moe is not None:
                m = self.moe
                per_layer += D * m.n_experts  # router
                per_layer += m.n_experts * 3 * D * m.d_ff_expert
                per_layer += m.n_shared_experts * 3 * D * m.d_ff_expert
            else:
                per_layer += mlp_params(F)
        p += self.n_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            p += attn_params() + mlp_params(F) + 2 * D  # one shared block
        if self.is_encdec:
            enc_per = 2 * D + attn_params() + mlp_params(F)
            cross_per = D + attn_params()
            p += self.n_enc_layers * enc_per + self.n_layers * cross_per
        return p

    def n_active_params(self) -> int:
        """Active params per token (for MoE MODEL_FLOPS = 6*N_active*D)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        dense_expert_delta = (m.n_experts - m.top_k - m.n_shared_experts) \
            * 3 * self.d_model * m.d_ff_expert
        return self.n_params() - self.n_layers * dense_expert_delta


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS: List[str] = [
    "zamba2_1p2b", "gemma2_9b", "codeqwen15_7b", "chatglm3_6b", "qwen3_4b",
    "mamba2_780m", "kimi_k2_1t_a32b", "mixtral_8x7b", "internvl2_26b",
    "whisper_small",
]

#: CLI alias map (``--arch`` accepts either form)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    arch_id = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def smoke(cfg: ArchConfig, vocab: int = 128) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: Dict[str, Any] = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128, vocab=vocab, d_head=16)
    if cfg.moe is not None:
        # generous capacity: smoke tests must be drop-free so that decode
        # and teacher-forced forward agree exactly
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
                            capacity_factor=8.0)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
        kw["enc_seq"] = 16
    if cfg.n_frontend_tokens:
        kw["n_frontend_tokens"] = 8
    if cfg.window is not None:
        kw["window"] = 32
    return replace(cfg, **kw)
