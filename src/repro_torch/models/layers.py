"""Dense transformer building blocks, the port of ``models/layers.py``:
RMSNorm, RoPE, GQA attention (dense reference and chunked online
softmax), the qk-normed attention projections, the self-attention and
cross-attention blocks, the gated MLP and the decode-time KV cache
(``cache_update``, ``decode_attention_block``, with the int8 ``kv_quant``
cache: ``quantize_kv``, ``dequantize_kv``, ``cache_kv_values``).

Plain functions on tensors; params are the nested dicts of
``models.params`` in the reference's einsum layouts. The reference's
sharding annotations have no counterpart on one card and are dropped.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DENSE_ATTN_MAX_KV = 2048  # above this, use the chunked online-softmax path


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) int. ``fraction<1`` rotates
    only the first ``fraction*Dh`` dims (chatglm-style 2d RoPE). The
    rotation is half-split, not interleaved."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    # positions (..., S) -> angles (..., S, 1, half) broadcasting over heads
    ang = positions.float()[..., None, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, xp], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) additive bias: 0 where visible, -inf where masked.
    pos_k < 0 marks invalid (unwritten cache) slots."""
    ok = pos_k[..., None, :] >= 0
    if causal:
        ok = ok & (pos_k[..., None, :] <= pos_q[..., :, None])
    if window is not None:
        ok = ok & (pos_k[..., None, :] > pos_q[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=pos_k.device)
    return torch.where(ok, zero, -math.inf)


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return torch.tanh(s / cap) * cap


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  pos_q: torch.Tensor, pos_k: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense reference attention. q (B,Sq,H,Dh); k/v (B,Sk,Kv,Dh); GQA via
    head grouping. pos_q (B,Sq) / pos_k (B,Sk) absolute positions."""
    B, Sq, H, Dh = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, Kv, rep, Dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    s = _softcap(s, softcap)
    s = s + _mask_bias(pos_q, pos_k, causal, window)[:, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def _chunk_math(qg, pos_q, kci, vci, pci, m, l, acc, *, causal, window,
                softcap):
    """One KV chunk of the online softmax: the carried (m, l, acc) after
    the chunk's keys kci/vci at positions pci."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kci.float())
    s = _softcap(s, softcap)
    s = s + _mask_bias(pos_q, pci, causal, window)[:, None, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(torch.where(torch.isneginf(m), m_safe, m) - m_safe)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bgrqk,bkgd->bqgrd", p, vci.float())
    acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l, acc


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      pos_q: torch.Tensor, pos_k: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention looping over KV chunks: O(Sq * kv_chunk)
    score memory instead of O(Sq * Sk). Matches attention_ref.

    Under autograd each chunk runs under ``torch.utils.checkpoint``, so
    the backward keeps only each chunk's inputs and carried (m, l, acc)
    and recomputes the chunk's scores, as the reference's
    ``jax.checkpoint(policy=nothing_saveable)`` does; without it every
    chunk's softmax would be saved and the memory would be O(Sq * Sk)
    again. Without grad the loop runs as it is (the same forward bits)."""
    B, Sq, H, Dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if Sk % kv_chunk != 0:
        pad = kv_chunk - Sk % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(pos_k, (0, pad), value=-1)
        Sk += pad
    rep = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, Kv, rep, Dh).float() * scale
    m = torch.full((B, Kv, rep, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, Kv, rep, Sq), device=q.device)
    acc = torch.zeros((B, Sq, Kv, rep, Dh), device=q.device)
    body = functools.partial(_chunk_math, causal=causal, window=window,
                             softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        body = functools.partial(checkpoint, body, use_reentrant=False)
    for c0 in range(0, Sk, kv_chunk):
        m, l, acc = body(qg, pos_q, k[:, c0:c0 + kv_chunk],
                         v[:, c0:c0 + kv_chunk], pos_k[:, c0:c0 + kv_chunk],
                         m, l, acc)
    l = torch.clamp(l, min=1e-20).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(B, Sq, H, Dh).to(q.dtype)


def attention(q, k, v, **kw) -> torch.Tensor:
    if k.shape[1] <= DENSE_ATTN_MAX_KV:
        kw.pop("kv_chunk", None)
        return attention_ref(q, k, v, **kw)
    return attention_chunked(q, k, v, **kw)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def attn_project_qkv(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,Kv,Dh), with RoPE + qk-norm."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attn_out(o: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def self_attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                         *, positions: torch.Tensor, window: Optional[int],
                         kv_chunk: int = 1024) -> torch.Tensor:
    """Training self-attention over the full sequence (causal), on the
    plain attention path (the loss runs under autograd; the flash kernel
    is forward-only)."""
    q, k, v = attn_project_qkv(x, p, cfg, positions)
    o = attention(q, k, v, pos_q=positions, pos_k=positions, causal=True,
                  window=window, softcap=cfg.attn_softcap,
                  scale=cfg.attn_logit_scale, kv_chunk=kv_chunk)
    return attn_out(o, p)


def cross_attention_block(x: torch.Tensor,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor],
                          p: Dict[str, torch.Tensor], cfg, *,
                          positions: torch.Tensor, flash=None
                          ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (B, Sk,
    Kv, Dh): q from ``x``, keys at ``arange(Sk)``, not causal, no window,
    the config's softcap. ``flash`` (the model passes ``flash_mha`` in the
    prefill under ``use_kernel``) computes the attention in place of the
    plain ``attention``: with every key visible to every query its
    index-based mask is this position-based one."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = enc_kv
    if flash is not None:
        o = flash(q, k, v, causal=False, window=None,
                  softcap=cfg.attn_softcap)
    else:
        pos_k = torch.arange(k.shape[1], device=k.device).expand(
            k.shape[:2])
        o = attention(q, k, v, pos_q=positions, pos_k=pos_k, causal=False,
                      window=None, softcap=cfg.attn_softcap)
    return attn_out(o, p)


def mlp_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg
              ) -> torch.Tensor:
    """Gated (3-matrix) or plain MLP; gelu is the tanh approximation."""
    act = F.silu if cfg.mlp_activation == "silu" else (
        lambda u: F.gelu(u, approximate="tanh"))
    if cfg.mlp_gated:
        h = act(torch.einsum("bsd,df->bsf", x, p["w_gate"])) \
            * torch.einsum("bsd,df->bsf", x, p["w_up"])
    else:
        h = act(torch.einsum("bsd,df->bsf", x, p["w_up"]))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


# -- decode-time KV cache -----------------------------------------------------

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) int8 quantization, the reference's: x (..., Dh) ->
    (int8 (..., Dh), fp32 scale (...,)), ``scale = amax / 127 + 1e-12``
    and the ints ``round(x / scale)`` (half to even, as ``jnp.round``)
    clipped to +-127. 1 B an element plus 4 B a (token, head)."""
    x = x.float()
    scale = torch.amax(torch.abs(x), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def cache_update(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, cur: int, window: Optional[int]
                 ) -> Dict[str, torch.Tensor]:
    """Write one token's k/v (B, 1, Kv, Dh) at position ``cur`` into a
    cache {k/v (B, S_cache, Kv, Dh), pos (S_cache,) with -1 = empty}; a
    quantized cache (int8 k/v, with ``k_scale``/``v_scale`` (B, S_cache,
    Kv) in fp32) gets ``quantize_kv`` of the token's k/v and their scales.
    Returns a new cache; the given one is not modified.

    With a window (the model's layer stack always passes one: INF_WINDOW
    where there is none) the slot is the ring-buffer slot ``cur % S_cache``.
    Without one it is ``cur``, clamped to the last slot as the reference's
    ``dynamic_update_slice`` clamps it."""
    s_cache = cache["k"].shape[1]
    cur = int(cur)
    slot = cur % s_cache if window is not None else min(cur, s_cache - 1)
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
        writes = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        writes = (("k", k_new), ("v", v_new))
    out = dict(cache)
    for name, new in writes:
        t = cache[name].clone()
        t[:, slot] = new[:, 0].to(t.dtype)
        out[name] = t
    out["pos"] = cache["pos"].clone()
    out["pos"][slot] = cur
    return out


def cache_kv_values(cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized (or raw) K/V views of a cache."""
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"], cache["k_scale"]),
                dequantize_kv(cache["v"], cache["v_scale"]))
    return cache["k"], cache["v"]


def decode_attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                           *, cache: Dict[str, torch.Tensor], cur: int,
                           window: Optional[int]):
    """Single-token self-attention against the cache. x: (B,1,D). Returns
    (y (B,1,D), the updated cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(cur), dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = attn_project_qkv(x, p, cfg, positions)
    new_cache = cache_update(cache, k_new, v_new, cur, window)
    pos_k = new_cache["pos"].expand(B, -1)
    k_eff, v_eff = cache_kv_values(new_cache)
    o = attention_ref(q, k_eff, v_eff, pos_q=positions,
                      pos_k=pos_k, causal=True, window=window,
                      softcap=cfg.attn_softcap, scale=cfg.attn_logit_scale)
    return attn_out(o, p), new_cache
