"""Analytic FLOP / HBM-byte / collective-byte model per (arch, shape, mesh).

Why analytic: XLA's ``compiled.cost_analysis()`` counts every while-loop
body exactly ONCE (verified empirically in this repo), so any scanned
program (layer stacks, microbatch accumulation, chunked attention) is
undercounted by the product of trip counts. The roofline table therefore
uses this model, **calibrated** against unrolled-HLO compiles on small
cells (see EXPERIMENTS.md §Roofline calibration); the compiled artifact
still provides the memory analysis, the collective census, and the
compile-success proof.

All numbers are GLOBAL (whole mesh); the roofline divides by chips.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..configs.base import ArchConfig, ShapeConfig

BF16 = 2
F32 = 4


@dataclass
class CostModel:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    detail: Dict[str, float]


def _attn_context(S: int, window: Optional[int], kind: str,
                  local_global: bool, block_skip: bool = False) -> float:
    """Average attended context length per query token.

    ``block_skip=False`` models the XLA chunked-softmax path, which computes
    every (q, kv) block and masks (full S); ``block_skip=True`` models the
    Pallas flash kernel, whose ``pl.when`` guard skips fully-masked blocks
    (~S/2 for causal, ~window for sliding windows).
    """
    causal_frac = 0.5 if block_skip else 1.0
    if kind == "decode":
        full = float(S)  # cache length
        loc = float(min(window or S, S))
    else:
        full = S * causal_frac
        if window and S > window:
            loc = float(window) if block_skip else S * causal_frac
        else:
            loc = full
    if local_global:
        return 0.5 * full + 0.5 * loc
    if window:
        return loc
    return full


def _layer_flops_fwd(cfg: ArchConfig, B: int, S: int, kind: str,
                     ctx_len: Optional[int] = None,
                     block_skip: bool = False) -> Dict[str, float]:
    """Forward FLOPs for ONE decoder layer (global). ``S`` = tokens
    processed per sequence (1 for decode); ``ctx_len`` = attended context
    (cache length for decode; defaults to S)."""
    D, H, Kv, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    T = B * S
    out: Dict[str, float] = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        out["qkvo"] = 2.0 * T * D * (2 * H * Dh + 2 * Kv * Dh)
        ctx = _attn_context(ctx_len if ctx_len is not None else S,
                            cfg.window, kind, cfg.local_global_pattern,
                            block_skip)
        out["attn_sdpa"] = 2.0 * 2.0 * T * H * Dh * ctx
        if cfg.moe is not None:
            m = cfg.moe
            out["router"] = 2.0 * T * D * m.n_experts
            eff_tokens = T * m.top_k * m.capacity_factor
            out["experts"] = 2.0 * eff_tokens * 3 * D * m.d_ff_expert
            if m.n_shared_experts:
                out["shared_exp"] = 2.0 * T * 3 * D * \
                    m.d_ff_expert * m.n_shared_experts
        else:
            out["mlp"] = 2.0 * T * D * F * (3 if cfg.mlp_gated else 2)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        inner = s.expand * D
        hs = inner // s.head_dim
        gn = s.n_groups * s.d_state
        out["ssm_proj"] = 2.0 * T * D * (2 * inner + 2 * gn + hs) \
            + 2.0 * T * inner * D
        out["ssm_conv"] = 2.0 * T * (inner + 2 * gn) * s.d_conv
        if kind == "decode":
            # recurrent step: state update + output, O(H*P*N)
            out["ssm_scan"] = 5.0 * T * hs * s.head_dim * s.d_state
        else:
            q = s.chunk
            n = s.d_state
            p = s.head_dim
            # intra: CB^T (2*T*q*n*hs) + (CB.L)X (2*T*q*p*hs);
            # states + y_inter: 2 * (2*T*n*p*hs)
            out["ssm_scan"] = (2.0 * T * q * n * hs + 2.0 * T * q * p * hs
                               + 4.0 * T * n * p * hs)
    return out


def cfg_cache_len(cfg: ArchConfig, S: int) -> int:
    if cfg.window is not None and not cfg.local_global_pattern:
        return min(cfg.window, S)
    return S


def cost(cfg: ArchConfig, shape: ShapeConfig, *, chips: int,
         model_shards: int, data_shards: int, remat: str = "full",
         dtype_bytes: int = BF16, opt_name: str = "adamw",
         attn_block_skip: bool = False,
         compress_grads: bool = False,
         zero_stage: int = 3, kv_quant: bool = False) -> CostModel:
    B = shape.global_batch
    kind = shape.kind
    Vp = -(-cfg.vocab // 256) * 256
    D = cfg.d_model
    # tokens through the stack / through the logits head
    T = B * (1 if kind == "decode" else shape.seq_len)
    S_text = 1 if kind == "decode" else (
        shape.seq_len - cfg.n_frontend_tokens if cfg.family == "vlm"
        else shape.seq_len)

    detail: Dict[str, float] = {}
    # decoder stack
    s_tok = 1 if kind == "decode" else shape.seq_len
    ctx_len = cfg_cache_len(cfg, shape.seq_len) if kind == "decode" \
        else shape.seq_len
    per_layer = _layer_flops_fwd(cfg, B, s_tok, kind, ctx_len=ctx_len,
                                 block_skip=attn_block_skip)
    for k, v in per_layer.items():
        detail[k] = v * cfg.n_layers
    # hybrid: shared attention block applied n_apps times
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        n_apps = cfg.n_layers // cfg.hybrid_attn_every
        dense_like = ArchConfig(
            arch_id="_shared", family="dense", n_layers=1, d_model=D,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
            vocab=cfg.vocab, d_head=cfg.d_head, window=cfg.window)
        sb = _layer_flops_fwd(dense_like, B, s_tok, kind,
                              ctx_len=min(cfg.window or shape.seq_len,
                                          shape.seq_len),
                              block_skip=attn_block_skip)
        for k, v in sb.items():
            detail["shared_" + k] = v * n_apps
    # encoder (audio)
    if cfg.is_encdec and kind != "decode":
        enc = _layer_flops_fwd(
            ArchConfig(arch_id="_enc", family="dense", n_layers=1,
                       d_model=D, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                       vocab=cfg.vocab, d_head=cfg.d_head,
                       mlp_gated=cfg.mlp_gated), B, cfg.enc_seq, "prefill")
        for k, v in enc.items():
            detail["enc_" + k] = v * cfg.n_enc_layers
    if cfg.is_encdec:
        # cross attention: q/o proj + kv proj over enc_seq + sdpa
        Hd = cfg.n_heads * cfg.head_dim
        Tq = B * (1 if kind == "decode" else shape.seq_len)
        detail["cross"] = cfg.n_layers * (
            2.0 * Tq * D * 2 * Hd
            + (0 if kind == "decode" else 2.0 * B * cfg.enc_seq * D * 2 * Hd)
            + 2.0 * 2.0 * Tq * Hd * cfg.enc_seq)
    # logits
    Tl = B * S_text
    detail["logits"] = 2.0 * Tl * D * Vp

    fwd = sum(detail.values())
    if kind == "train":
        remat_extra = {"full": 1.0, "dots": 0.33, "none": 0.0}[remat]
        flops = fwd * (3.0 + remat_extra)
    else:
        flops = fwd

    # ---------------- HBM bytes (global) ----------------
    P = cfg.n_params()
    act_unit = T * D * dtype_bytes
    if kind == "train":
        opt_b = 36.0 if opt_name == "adamw" else 14.0
        hbm = P * (2 * dtype_bytes + opt_b)        # params fwd+bwd + opt
        hbm += act_unit * cfg.n_layers * 12.0      # residual-stream traffic
        hbm += Tl * Vp * F32 * 2                   # logits write+read
    elif kind == "prefill":
        hbm = P * dtype_bytes + act_unit * cfg.n_layers * 8.0 \
            + Tl * Vp * F32
        hbm += cache_bytes(cfg, shape, kv_quant)   # cache write
    else:
        hbm = P * dtype_bytes + act_unit * cfg.n_layers * 8.0 \
            + Tl * Vp * F32
        hbm += cache_bytes(cfg, shape, kv_quant)   # cache read (+write slice)
    # MoE expert weights are read once regardless of token routing
    # (already inside P); capacity buffers:
    if cfg.moe is not None and kind == "train":
        m = cfg.moe
        hbm += T * m.top_k * m.capacity_factor * D * dtype_bytes * 4

    # ---------------- collective bytes (global, ring algorithms) ----------
    # Conventions: a ring all-gather / reduce-scatter of a tensor of SIZE
    # bytes sharded over g devices moves (g-1)/g * SIZE per device, i.e.
    # (g-1) * SIZE summed over the group. A ring all-reduce moves twice
    # that. ``act_unit`` is the GLOBAL activation tensor (T x D x dtype).
    d, ms = max(data_shards, 1), max(model_shards, 1)
    coll = 0.0
    if kind == "train":
        if zero_stage == 3:
            # FSDP/ZeRO-3: params sharded over data; all-gather each pass
            # (fwd + bwd [+ remat fwd]); reduce-scatter fp32 (or int8) grads
            fsdp_passes = 3.0 if remat == "full" else 2.0
            coll += dtype_bytes * P * (d - 1) * fsdp_passes
            grad_b = 1.0 if compress_grads else F32
            coll += grad_b * P * (d - 1)
        else:
            # ZeRO-1: params replicated over data; ring all-reduce grads +
            # broadcast updated params (only feasible when P/m fits HBM)
            grad_b = 1.0 if compress_grads else F32
            coll += 2.0 * grad_b * P * (d - 1)
            coll += dtype_bytes * P * (d - 1)
    # Megatron-style activation all-reduces: 2 per layer, each a ring AR
    # of the per-data-shard activation within the model group.
    n_ar = 2.0 if kind == "train" else 2.0
    coll += cfg.n_layers * n_ar * 2.0 * (ms - 1) * act_unit / d
    if cfg.moe is not None:
        m = cfg.moe
        # expert dispatch/combine all-to-all: each device exchanges its
        # (1 - 1/m) share of the local capacity buffer, twice per layer
        a2a_global = T * m.top_k * m.capacity_factor * D * dtype_bytes
        coll += 2.0 * cfg.n_layers * a2a_global * (ms - 1) / ms
        if kind == "train":
            coll += 2.0 * cfg.n_layers * a2a_global * (ms - 1) / ms  # bwd

    return CostModel(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                     detail=detail)


def cache_bytes(cfg: ArchConfig, shape: ShapeConfig,
                kv_quant: bool = False) -> float:
    B, S = shape.global_batch, shape.seq_len
    # int8 KV: 1 B/elem + one fp32 scale per head-dim vector (~1.03 B/elem)
    kv_b = (1.0 + F32 / max(cfg.head_dim, 1)) if kv_quant else BF16
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        cl = cfg_cache_len(cfg, S)
        b = 2.0 * cfg.n_layers * B * cl * cfg.n_kv_heads * cfg.head_dim * kv_b
        if cfg.is_encdec:
            b += 2.0 * cfg.n_layers * B * cfg.enc_seq * cfg.n_kv_heads \
                * cfg.head_dim * BF16
        return b
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    hs = inner // s.head_dim
    b = cfg.n_layers * B * (hs * s.head_dim * s.d_state * F32
                            + (inner + 2 * s.n_groups * s.d_state)
                            * (s.d_conv - 1) * BF16)
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.hybrid_attn_every
        wl = min(cfg.window or S, S)
        b += 2.0 * n_apps * B * wl * cfg.n_kv_heads * cfg.head_dim * BF16
    return b
