"""The port of ``models/model.py``: the padded vocab, the token embedding
and the (tied) output head, which the paged serving engine uses; the
static generation path (``init_cache`` / ``prefill`` / ``decode_step``)
for the dense family (qwen3, gemma2, chatglm3, codeqwen), the moe family
(mixtral, kimi; the dense layers with ``models.moe.moe_block`` in place
of the MLP) and the ssm family (mamba2), which the static serving
discipline uses; and the training forward and loss (``loss_fn``, with
the moe aux losses) for the same three families. The parameter trees are
``models.params.init_params``.

The layer stack is a Python loop over the layers of the stacked
``(L, ...)`` layer tree (each leaf ``unbind`` once) where the reference
runs ``lax.scan``; the caches come back stacked on L as there.
``use_kernel`` picks the hand-written kernel of each family's prefill: the
flash-attention kernel for every dense or moe layer's attention, the SSD
intra-chunk kernel for every mamba2 layer. The loss runs the plain paths
under autograd whatever ``use_kernel`` says: neither kernel has a
backward. The other families are not ported yet: their entry points raise.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.flash_attention import flash_mha
from . import ssm as ssm_lib
from .moe import moe_block
from .layers import (attention, attn_out, attn_project_qkv,
                     decode_attention_block, mlp_block, rmsnorm,
                     self_attention_block)
from .params import padded_vocab, unstack_layers

INF_WINDOW = 1 << 30  # "no window" sentinel for per-layer window arrays


class Model:
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True):
        self.cfg = cfg
        self.dtype = dtype
        # the prefill's kernel (flash attention for dense, the SSD
        # intra-chunk terms for ssm) on CUDA tensors or, with False, the
        # reference's plain code on any device (the run that the kernel's
        # tokens are held against on the card)
        self.use_kernel = use_kernel
        # pad vocab to a multiple of 256, as the reference does (odd vocabs
        # shard cleanly there; here it keeps the two trees identical)
        self.vocab_pad = padded_vocab(cfg.vocab)

    def _embed(self, params, tokens: torch.Tensor,
               pos0: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """tokens (B, S) -> (B, S, D). ``pos0`` (an int or a (B,) tensor of
        per-row start positions) only matters for learned positions."""
        cfg = self.cfg
        x = params["embed"][tokens].to(self.dtype)
        if cfg.scale_embeddings:
            x = x * math.sqrt(cfg.d_model)
        if cfg.pos_embedding == "learned":
            s = tokens.shape[1]
            if isinstance(pos0, int):
                pe = params["pos_embed"][pos0:pos0 + s][None]
            else:
                idx = pos0.reshape(-1, 1) + torch.arange(s, device=x.device)
                pe = params["pos_embed"][idx]
            x = x + pe.to(self.dtype)
        return x

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) -> fp32 logits (B, S, V_pad); pad logits are -1e30."""
        cfg = self.cfg
        head = (params["embed"].t() if cfg.tie_embeddings
                else params["lm_head"])
        logits = torch.matmul(x.float(), head.float())
        if cfg.final_softcap is not None:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        if self.vocab_pad != cfg.vocab:  # mask pad region
            pad = torch.arange(self.vocab_pad, device=logits.device) \
                >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _static_family(self, what: str) -> None:
        if self.cfg.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(
                f"Model.{what}: family {self.cfg.family!r} is not ported "
                f"yet (the port's static path and loss serve the dense, moe "
                f"and ssm families)")

    def _ffn(self, h: torch.Tensor, lp):
        """The layer's feed-forward: the moe block (with its aux losses)
        where the config has experts, else the MLP (aux None)."""
        if self.cfg.moe is not None:
            return moe_block(h, lp["moe"], self.cfg)
        return mlp_block(h, lp["mlp"], self.cfg), None

    def _window_array(self) -> List[int]:
        """Each layer's attention window; INF_WINDOW where there is none,
        so that the layer functions always get a window (and the decode
        cache is always written at the ring-buffer slot ``cur % S``)."""
        cfg = self.cfg
        L = cfg.n_layers
        if cfg.local_global_pattern:  # gemma2: even layers local, odd global
            return [cfg.window if i % 2 == 0 else INF_WINDOW
                    for i in range(L)]
        if cfg.window is not None and cfg.family != "hybrid":
            return [cfg.window] * L
        return [INF_WINDOW] * L

    # -- caches -----------------------------------------------------------------
    def cache_len(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.window is not None and not cfg.local_global_pattern:
            return min(cfg.window, seq_len)
        return seq_len

    def init_cache(self, batch: int, seq_len: int, device=None
                   ) -> Dict[str, Any]:
        """Zeroed decode cache (reference ``init_cache``): the dense and moe
        families' K/V of ``cache_len(seq_len)`` slots a layer with
        ``pos = -1`` (empty) in every slot; the ssm family's states
        (``seq_len`` unused). ``device=None`` means the card."""
        self._static_family("init_cache")
        dev = resolve_device(device)
        cfg = self.cfg
        if cfg.family != "ssm":
            L, cl = cfg.n_layers, self.cache_len(seq_len)
            shape = (L, batch, cl, cfg.n_kv_heads, cfg.head_dim)
            return {"attn": {
                "k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "pos": torch.full((L, cl), -1, dtype=torch.int32,
                                  device=dev)}}
        s = cfg.ssm
        inner = s.expand * cfg.d_model
        nheads = inner // s.head_dim
        conv_dim = inner + 2 * s.n_groups * s.d_state
        L = cfg.n_layers
        return {"ssm": {
            "state": torch.zeros((L, batch, nheads, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=dev),
            "conv": torch.zeros((L, batch, conv_dim, s.d_conv - 1),
                                dtype=self.dtype, device=dev)}}

    # -- prefill / decode -------------------------------------------------------
    def _dense_prefill(self, params, x: torch.Tensor, kv_chunk: int,
                       extra_cache: int):
        """The dense (or moe) layers and the final norm over x (B, S, D),
        positions ``arange(S)`` in every row. Returns (x, the K/V
        cache)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        cl = self.cache_len(S)
        kvs = []
        for lp, win in zip(unstack_layers(params["layers"]),
                           self._window_array()):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            q, k, v = attn_project_qkv(h, lp["attn"], cfg, positions)
            if self.use_kernel:
                # positions are the indices here, so the kernel's
                # index-based mask is the reference's position-based one
                o = flash_mha(q, k, v, causal=True, window=win,
                              softcap=cfg.attn_softcap,
                              scale=cfg.attn_logit_scale)
            else:
                o = attention(q, k, v, pos_q=positions, pos_k=positions,
                              causal=True, window=win,
                              softcap=cfg.attn_softcap,
                              scale=cfg.attn_logit_scale, kv_chunk=kv_chunk)
            x = x + attn_out(o, lp["attn"])
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + self._ffn(h, lp)[0]
            kvs.append(_collect_kv(k, v, cl, positions, self.dtype))
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        attn_cache = {n: torch.stack([c[n] for c in kvs])
                      for n in ("k", "v", "pos")}
        return x, _pad_kv(attn_cache, extra_cache, cfg)

    def _dense_decode(self, params, cache, x: torch.Tensor, cur: int):
        """One decode step of the dense (or moe) layers from ``cache``.
        Returns (x after the final norm, the new K/V cache)."""
        cfg = self.cfg
        new = []
        for lp, lc, win in zip(
                unstack_layers(params["layers"]),
                unstack_layers(cache["attn"]),
                self._window_array()):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            h, new_c = decode_attention_block(h, lp["attn"], cfg, cache=lc,
                                              cur=cur, window=win)
            x = x + h
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + self._ffn(h, lp)[0]
            new.append(new_c)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {n: torch.stack([c[n] for c in new])
                   for n in ("k", "v", "pos")}

    def _decoder_stack(self, params, x: torch.Tensor,
                       positions: torch.Tensor, *, remat: str,
                       kv_chunk: int):
        """The training forward of the dense (or moe) layers and the final
        norm over x (B, S, D), on the plain attention path. Returns (x,
        the moe aux losses summed over the layers; zeros without moe)."""
        cfg = self.cfg

        def body(x, aux_lb, aux_z, lp, win):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            x = x + self_attention_block(h, lp["attn"], cfg,
                                         positions=positions, window=win,
                                         kv_chunk=kv_chunk)
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            h, aux = self._ffn(h, lp)
            if aux is not None:
                aux_lb = aux_lb + aux["aux_lb"]
                aux_z = aux_z + aux["aux_z"]
            return x + h, aux_lb, aux_z

        body = _maybe_remat(body, remat)
        aux_lb = aux_z = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
        for lp, win in zip(unstack_layers(params["layers"]),
                           self._window_array()):
            x, aux_lb, aux_z = body(x, aux_lb, aux_z, lp, win)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {"aux_lb": aux_lb, "aux_z": aux_z}

    def _ssm_stack(self, params, x: torch.Tensor, cache=None, *,
                   remat: str = "none", use_kernel: bool = None):
        """The mamba2 layers and the final norm over x (B, S, D): a prefill
        when ``cache`` is None, else one decode step from ``cache``.
        ``use_kernel`` (default: the model's) picks the SSD kernel or its
        plain version; ``remat`` recomputes each layer in the backward.
        Returns (x, the new per-layer states stacked on L)."""
        cfg = self.cfg
        if use_kernel is None:
            use_kernel = self.use_kernel

        def body(x, lp, state, conv):
            kw = {} if state is None else dict(
                ssm_state=state, conv_state=conv, decode=True)
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            h, new = ssm_lib.mamba2_block(h, lp["mamba"], cfg,
                                          use_kernel=use_kernel, **kw)
            return x + h, new

        body = _maybe_remat(body, remat)
        old = ([(None, None)] * cfg.n_layers if cache is None else
               zip(cache["ssm"]["state"].unbind(0),
                   cache["ssm"]["conv"].unbind(0)))
        states, convs = [], []
        for lp, (state, conv) in zip(unstack_layers(params["layers"]), old):
            x, (s_new, c_new) = body(x, lp, state, conv)
            states.append(s_new)
            convs.append(c_new)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {"state": torch.stack(states), "conv": torch.stack(convs)}

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *,
                remat: str = "none", kv_chunk: int = 1024):
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels``, (B, S); labels below 0 are masked). Returns (loss,
        {"loss": loss}); with moe the loss adds ``0.01 * aux_lb / L +
        1e-3 * aux_z / L`` and the metrics keep the cross-entropy as
        ``loss`` beside ``aux_lb``, as the reference's. ``remat`` is
        ``none``, ``dots`` (matmul outputs saved, the rest recomputed) or
        ``full`` (each layer recomputed in the backward)."""
        self._static_family("loss_fn")
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        x = self._embed(params, tokens)
        if cfg.family == "ssm":
            x, _ = self._ssm_stack(params, x, remat=remat,
                                   use_kernel=False)
        else:
            positions = torch.arange(x.shape[1], device=x.device).expand(
                x.shape[:2])
            x, aux = self._decoder_stack(params, x, positions, remat=remat,
                                         kv_chunk=kv_chunk)
        loss = softmax_xent(self._logits(params, x), labels)
        metrics = {"loss": loss}
        if cfg.moe is not None:
            loss = loss + 0.01 * aux["aux_lb"] / cfg.n_layers \
                + 1e-3 * aux["aux_z"] / cfg.n_layers
            metrics["aux_lb"] = aux["aux_lb"]
        return loss, metrics

    def prefill(self, params, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 1024, extra_cache: int = 0):
        """Full-sequence forward that also fills a decode cache. Returns
        (last-token logits (B, 1, V_pad), cache). ``extra_cache`` reserves
        cache slots for the decode steps that follow (serving path);
        ``kv_chunk`` is the plain attention's chunk above
        ``DENSE_ATTN_MAX_KV`` keys. With ``use_kernel`` each dense layer's
        attention runs the flash kernel once, each ssm layer's SSD the
        intra-chunk kernel once. The ssm family has no attention cache.
        """
        self._static_family("prefill")
        x = self._embed(params, batch["tokens"])
        if self.cfg.family != "ssm":
            x, cache = self._dense_prefill(params, x, kv_chunk, extra_cache)
            return self._logits(params, x[:, -1:]), {"attn": cache}
        x, ssm_cache = self._ssm_stack(params, x)
        return self._logits(params, x[:, -1:]), {"ssm": ssm_cache}

    def decode_step(self, params, cache, tokens: torch.Tensor, cur):
        """One decode step. tokens (B, 1); ``cur`` is the position of the
        tokens (an int; unused by the ssm family). Returns (logits
        (B, 1, V_pad), new cache); the given cache is not modified."""
        self._static_family("decode_step")
        x = self._embed(params, tokens, pos0=int(cur))
        new_cache = dict(cache)
        if self.cfg.family != "ssm":
            x, new_cache["attn"] = self._dense_decode(params, cache, x,
                                                      int(cur))
        else:
            x, new_cache["ssm"] = self._ssm_stack(params, x, cache)
        return self._logits(params, x), new_cache


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

# the matmuls that ``remat="dots"`` keeps (the reference's
# ``checkpoint_dots``): einsum reaches ATen as one of these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(body, remat: str):
    """The reference's ``_maybe_remat`` on ``torch.utils.checkpoint``."""
    if remat == "none":
        return body
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        save_dots = functools.partial(create_selective_checkpoint_contexts,
                                      _dots_policy)
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 context_fn=save_dots)
    raise ValueError(f"remat must be none, dots or full; got {remat!r}")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean cross-entropy; labels < 0 are masked out."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)


def _collect_kv(k, v, cl, positions, dtype) -> Dict[str, torch.Tensor]:
    """Prefill-path cache slice of one layer: the last ``cl`` positions."""
    return {"pos": positions[0, -cl:].to(torch.int32),
            "k": k[:, -cl:].to(dtype), "v": v[:, -cl:].to(dtype)}


def _pad_kv(attn_cache: Dict[str, torch.Tensor], extra: int, cfg
            ) -> Dict[str, torch.Tensor]:
    """Right-pad prefilled KV caches (k/v (L, B, cl, Kv, Dh), pos (L, cl))
    with ``extra`` empty slots (pos -1) so decode can append. No-op for
    ring-buffered (windowed) caches already at their window size, and when
    extra == 0."""
    if extra <= 0:
        return attn_cache
    cl = attn_cache["k"].shape[2]
    if cfg.window is not None and not cfg.local_global_pattern:
        if cl >= cfg.window:
            return attn_cache  # true ring buffer: decode wraps via cur % W
        extra = min(extra, cfg.window - cl)  # grow toward the window size
    out = dict(attn_cache)
    out["k"] = F.pad(attn_cache["k"], (0, 0, 0, 0, 0, extra))
    out["v"] = F.pad(attn_cache["v"], (0, 0, 0, 0, 0, extra))
    out["pos"] = F.pad(attn_cache["pos"], (0, extra), value=-1)
    return out
