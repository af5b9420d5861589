"""The port of ``models/model.py``: the padded vocab, the token embedding
and the (tied) output head, which the paged serving engine uses; the
static generation path (``init_cache`` / ``prefill`` / ``decode_step``),
which the static serving discipline uses, and the training forward and
loss (``loss_fn``, with the moe aux losses), for every family of the
reference:

* decoder LM — dense (qwen3, gemma2, chatglm3, codeqwen), moe (mixtral,
  kimi; ``models.moe.moe_block`` in place of the MLP) and vlm (internvl2;
  the ``patch_embed`` prefix ahead of the tokens);
* ssm LM (mamba2) — the mamba2 layers;
* hybrid (zamba2) — segments of mamba2 layers, each followed by ONE
  shared attention+MLP block, then the remainder layers without it;
* enc-dec (whisper) — the encoder over ``frame_embed`` plus learned
  positions, then the decoder with cross-attention to its output.

The parameter trees are ``models.params.init_params``. The layer stacks
are Python loops over the layers of the stacked ``(L, ...)`` trees (each
leaf ``unbind`` once) where the reference runs ``lax.scan``; the caches
come back stacked on L as there. ``use_kernel`` picks the hand-written
kernel of each prefill: the flash-attention kernel for every attention
(the dense, moe and vlm layers, the hybrid's shared block, the encoder,
the decoder's self- and cross-attention), the SSD intra-chunk kernel for
every mamba2 layer. Decode runs the plain attention. The loss runs the
plain paths under autograd whatever ``use_kernel`` says: neither kernel
has a backward. ``kv_quant`` keeps the attention caches (the layers',
the hybrid's shared block's, the audio decoder's self-attention) in int8
with an fp32 scale a (token, head), as the reference's; the audio
family's encoder K/V stay in the model's dtype. An unknown family raises
``ValueError``.
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
                     cross_attention_block, decode_attention_block,
                     mlp_block, quantize_kv, rmsnorm, self_attention_block)
from .params import padded_vocab, unstack_layers

INF_WINDOW = 1 << 30  # "no window" sentinel for per-layer window arrays
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


class Model:
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True, kv_quant: bool = False):
        self.cfg = cfg
        self.dtype = dtype
        self.kv_quant = kv_quant  # int8 KV caches (decode memory lever)
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
                # the reference's decode slices at a traced position, and
                # its dynamic_slice clamps the start into [0, rows - s]
                start = min(max(pos0, 0), params["pos_embed"].shape[0] - s)
                pe = params["pos_embed"][start:start + s][None]
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

    def _family(self) -> str:
        """The config's family; an unknown one raises ``ValueError``, as
        the reference's dispatch does where it finds no branch."""
        if self.cfg.family not in FAMILIES:
            raise ValueError(self.cfg.family)
        return self.cfg.family

    def _ffn(self, h: torch.Tensor, lp):
        """The layer's feed-forward: the moe block (with its aux losses)
        where the config has experts, else the MLP (aux None)."""
        if self.cfg.moe is not None:
            return moe_block(h, lp["moe"], self.cfg)
        return mlp_block(h, lp["mlp"], self.cfg), None

    def _window_array(self) -> List[int]:
        """Each layer's attention window; INF_WINDOW where there is none,
        so that the layer functions always get a window (and the decode
        cache is always written at the ring-buffer slot ``cur % S``). The
        hybrid's window belongs to its shared block, not to its layers."""
        cfg = self.cfg
        L = cfg.n_layers
        if cfg.local_global_pattern:  # gemma2: even layers local, odd global
            return [cfg.window if i % 2 == 0 else INF_WINDOW
                    for i in range(L)]
        if cfg.window is not None and cfg.family != "hybrid":
            return [cfg.window] * L
        return [INF_WINDOW] * L

    def _prefill_attention(self, q, k, v, positions, *, causal: bool,
                           window, softcap, scale=None, kv_chunk: int = 1024,
                           use_kernel: bool = None) -> torch.Tensor:
        """A prefill's self-attention over ``positions`` (``arange(S)`` in
        every row): the flash kernel under ``use_kernel`` (default: the
        model's; the positions are the indices, so its index-based mask
        is the reference's position-based one), else the plain
        ``attention``."""
        if self.use_kernel if use_kernel is None else use_kernel:
            return flash_mha(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
        return attention(q, k, v, pos_q=positions, pos_k=positions,
                         causal=causal, window=window, softcap=softcap,
                         scale=scale, kv_chunk=kv_chunk)

    # -- caches -----------------------------------------------------------------
    def cache_len(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.window is not None and not cfg.local_global_pattern:
            return min(cfg.window, seq_len)
        return seq_len

    def init_cache(self, batch: int, seq_len: int, device=None
                   ) -> Dict[str, Any]:
        """Zeroed decode cache (reference ``init_cache``): K/V of
        ``cache_len(seq_len)`` slots a layer with ``pos = -1`` (empty) in
        every slot for the dense, moe, vlm and audio families; the ssm
        states for the ssm and hybrid families; the hybrid's shared block
        K/V of ``min(window or seq_len, seq_len)`` slots for each of its
        ``n_layers // hybrid_attn_every`` applications; the audio
        family's encoder K/V (``cross_k`` / ``cross_v``, zeros of
        ``enc_seq`` rows a layer). With ``kv_quant`` the K/V are int8
        zeros beside ``k_scale``/``v_scale`` (n, batch, slots, Kv) fp32
        zeros. ``device=None`` means the card."""
        family = self._family()
        dev = resolve_device(device)
        cfg = self.cfg
        L = cfg.n_layers
        kv = functools.partial(_kv_cache, batch=batch, kv=cfg.n_kv_heads,
                               dh=cfg.head_dim, dtype=self.dtype, device=dev,
                               quant=self.kv_quant)
        if family in ("dense", "moe", "vlm", "audio"):
            cache = {"attn": kv(L, self.cache_len(seq_len))}
        else:
            cache = {"ssm": _ssm_cache(cfg, L, batch, self.dtype, dev)}
        if family == "hybrid":
            cache["shared_attn"] = kv(L // cfg.hybrid_attn_every,
                                      min(cfg.window or seq_len, seq_len))
        if family == "audio":
            shape = (L, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
            cache["cross_k"] = torch.zeros(shape, dtype=self.dtype,
                                           device=dev)
            cache["cross_v"] = torch.zeros(shape, dtype=self.dtype,
                                           device=dev)
        return cache

    # -- dense / moe / vlm --------------------------------------------------------
    def _dense_prefill(self, params, x: torch.Tensor, kv_chunk: int,
                       extra_cache: int):
        """The dense (or moe, or vlm) layers and the final norm over x (B,
        S, D), positions ``arange(S)`` in every row. Returns (x, the K/V
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
            o = self._prefill_attention(
                q, k, v, positions, causal=True, window=win,
                softcap=cfg.attn_softcap, scale=cfg.attn_logit_scale,
                kv_chunk=kv_chunk)
            x = x + attn_out(o, lp["attn"])
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + self._ffn(h, lp)[0]
            kvs.append(_collect_kv(k, v, cl, positions, self.dtype,
                                   self.kv_quant))
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, _pad_kv(_stack_kv(kvs), extra_cache, cfg)

    def _dense_decode(self, params, cache, x: torch.Tensor, cur: int):
        """One decode step of the dense (or moe, vlm or audio decoder)
        layers from ``cache``; the audio decoder's layers attend the
        cache's encoder K/V after their self-attention. Returns (x after
        the final norm, the new K/V cache)."""
        cfg = self.cfg
        L = cfg.n_layers
        crosses = (zip(cache["cross_k"].unbind(0),
                       cache["cross_v"].unbind(0))
                   if cfg.family == "audio" else [None] * L)
        new = []
        for lp, lc, win, cross in zip(
                unstack_layers(params["layers"]),
                unstack_layers(cache["attn"]),
                self._window_array(), crosses):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            h, new_c = decode_attention_block(h, lp["attn"], cfg, cache=lc,
                                              cur=cur, window=win)
            x = x + h
            if cross is not None:
                hq = rmsnorm(x, lp["ln_x"], cfg.rmsnorm_eps)
                pos_q = torch.full((x.shape[0], 1), cur, device=x.device)
                x = x + cross_attention_block(hq, cross, lp["cross"], cfg,
                                              positions=pos_q)
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + self._ffn(h, lp)[0]
            new.append(new_c)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, _stack_kv(new)

    def _decoder_stack(self, params, x: torch.Tensor,
                       positions: torch.Tensor, *, remat: str,
                       kv_chunk: int):
        """The training forward of the dense (or moe, or vlm) layers and
        the final norm over x (B, S, D), on the plain attention path.
        Returns (x, the moe aux losses summed over the layers; zeros
        without moe)."""
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

    # -- ssm and hybrid -----------------------------------------------------------
    def _mamba_layers(self, x: torch.Tensor, lps, olds, *, remat: str,
                      use_kernel: bool):
        """The mamba2 layers ``lps`` (layer trees) over x (B, S, D): a
        prefill where ``olds`` holds (None, None) for each, else one
        decode step from each layer's (state, conv). ``use_kernel`` picks
        the SSD kernel or its plain version; ``remat`` recomputes each
        layer in the backward. Returns (x, the new states, the new conv
        states)."""
        cfg = self.cfg

        def body(x, lp, state, conv):
            kw = {} if state is None else dict(
                ssm_state=state, conv_state=conv, decode=True)
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            h, new = ssm_lib.mamba2_block(h, lp["mamba"], cfg,
                                          use_kernel=use_kernel, **kw)
            return x + h, new

        body = _maybe_remat(body, remat)
        states, convs = [], []
        for lp, (state, conv) in zip(lps, olds):
            x, (s_new, c_new) = body(x, lp, state, conv)
            states.append(s_new)
            convs.append(c_new)
        return x, states, convs

    def _ssm_stack(self, params, x: torch.Tensor, cache=None, *,
                   remat: str = "none", use_kernel: bool = None):
        """The mamba2 layers and the final norm over x (B, S, D): a prefill
        when ``cache`` is None, else one decode step from ``cache``.
        ``use_kernel`` defaults to the model's. Returns (x, the new
        per-layer states stacked on L)."""
        cfg = self.cfg
        x, states, convs = self._mamba_layers(
            x, unstack_layers(params["layers"]),
            _ssm_olds(cache, cfg.n_layers), remat=remat,
            use_kernel=self.use_kernel if use_kernel is None else use_kernel)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {"state": torch.stack(states), "conv": torch.stack(convs)}

    def _hybrid_segments(self, params, x: torch.Tensor, cache, shared, *,
                         remat: str = "none", use_kernel: bool):
        """The zamba2 layout over x: ``n_layers // hybrid_attn_every``
        segments of ``hybrid_attn_every`` mamba2 layers, each followed by
        the shared attention+MLP block, then the remainder layers with no
        shared block after them; then the final norm. ``shared(h, ap,
        app)`` is the shared block's attention on the normed ``h`` with
        the block's attention params ``ap`` at application ``app``: it
        returns (its output, what the caller collects). ``cache`` (None in
        a prefill) gives the layers' (state, conv) for a decode step;
        ``remat`` wraps only the mamba layers, as the reference's does.
        Returns (x, the new ssm cache, the collected list)."""
        cfg = self.cfg
        L, k = cfg.n_layers, cfg.hybrid_attn_every
        n_seg = L // k
        sp = params["shared"]
        ap = {n: t[0] for n, t in sp["attn"].items()}
        mp = {n: t[0] for n, t in sp["mlp"].items()}
        lps = unstack_layers(params["layers"])
        olds = _ssm_olds(cache, L)
        states, convs, collected = [], [], []
        for seg in range(n_seg + 1):
            part = slice(seg * k, (seg + 1) * k if seg < n_seg else L)
            x, st, cv = self._mamba_layers(x, lps[part], olds[part],
                                           remat=remat,
                                           use_kernel=use_kernel)
            states += st
            convs += cv
            if seg == n_seg:
                break
            h = rmsnorm(x, sp["ln1"][0], cfg.rmsnorm_eps)
            h, out = shared(h, ap, seg)
            collected.append(out)
            x = x + h
            h = rmsnorm(x, sp["ln2"][0], cfg.rmsnorm_eps)
            x = x + mlp_block(h, mp, cfg)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {"state": torch.stack(states),
                   "conv": torch.stack(convs)}, collected

    def _hybrid_stack(self, params, x: torch.Tensor,
                      positions: torch.Tensor, *, remat: str,
                      kv_chunk: int):
        """The training forward of the hybrid family over x (B, S, D), on
        the plain paths. Returns x after the final norm."""
        cfg = self.cfg
        win = cfg.window or INF_WINDOW

        def shared(h, ap, _):
            return self_attention_block(h, ap, cfg, positions=positions,
                                        window=win, kv_chunk=kv_chunk), None
        return self._hybrid_segments(params, x, None, shared, remat=remat,
                                     use_kernel=False)[0]

    def _hybrid_prefill(self, params, x: torch.Tensor, kv_chunk: int,
                        extra_cache: int):
        """The hybrid prefill over x (B, S, D), positions ``arange(S)``:
        each mamba2 layer's SSD through the SSD kernel and each shared
        block's attention through the flash kernel (causal, the config's
        window) under ``use_kernel``. Returns (x, the cache: every layer's
        ssm states, and each application's last ``min(window or S, S)``
        K/V)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        wl = min(cfg.window or S, S)

        def shared(h, ap, _):
            q, k, v = attn_project_qkv(h, ap, cfg, positions)
            o = self._prefill_attention(
                q, k, v, positions, causal=True,
                window=cfg.window or INF_WINDOW, softcap=cfg.attn_softcap,
                kv_chunk=kv_chunk)
            return attn_out(o, ap), _collect_kv(k, v, wl, positions,
                                                self.dtype, self.kv_quant)
        x, ssm_cache, kvs = self._hybrid_segments(
            params, x, None, shared, use_kernel=self.use_kernel)
        return x, {"ssm": ssm_cache,
                   "shared_attn": _pad_kv(_stack_kv(kvs), extra_cache, cfg)}

    def _hybrid_decode(self, params, cache, x: torch.Tensor, cur: int):
        """One hybrid decode step from ``cache``; the shared block writes
        its application's K/V at the ring-buffer slot. Returns (x after
        the final norm, the new cache)."""
        cfg = self.cfg
        apps = unstack_layers(cache["shared_attn"])

        def shared(h, ap, seg):
            return decode_attention_block(h, ap, cfg, cache=apps[seg],
                                          cur=cur,
                                          window=cfg.window or INF_WINDOW)
        x, ssm_cache, kvs = self._hybrid_segments(
            params, x, cache, shared, use_kernel=self.use_kernel)
        return x, {"ssm": ssm_cache, "shared_attn": _stack_kv(kvs)}

    # -- encoder-decoder ------------------------------------------------------------
    def _encode(self, params, frames: torch.Tensor, *, remat: str = "none",
                use_kernel: bool = False) -> torch.Tensor:
        """The encoder over ``frames`` (B, enc_seq, D) plus ``enc_pos``:
        not causal self-attention (through the flash kernel with
        ``use_kernel``) and the MLP in every layer; no final norm, as in
        the reference."""
        cfg = self.cfg
        x = frames.to(self.dtype) + params["enc_pos"][None].to(self.dtype)
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device).expand(B, S)

        def body(x, lp):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            q, k, v = attn_project_qkv(h, lp["attn"], cfg, pos)
            o = self._prefill_attention(q, k, v, pos, causal=False,
                                        window=None, softcap=None,
                                        use_kernel=use_kernel)
            x = x + attn_out(o, lp["attn"])
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            return x + mlp_block(h, lp["mlp"], cfg)

        body = _maybe_remat(body, remat)
        for lp in unstack_layers(params["enc_layers"]):
            x = body(x, lp)
        return x

    def _encdec_decoder(self, params, x: torch.Tensor,
                        enc_out: torch.Tensor, positions: torch.Tensor, *,
                        remat: str, kv_chunk: int) -> torch.Tensor:
        """The training forward of the decoder over x (B, S, D) against
        the encoder output, on the plain paths. Returns x after the final
        norm."""
        cfg = self.cfg

        def body(x, lp):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            x = x + self_attention_block(h, lp["attn"], cfg,
                                         positions=positions,
                                         window=INF_WINDOW,
                                         kv_chunk=kv_chunk)
            h = rmsnorm(x, lp["ln_x"], cfg.rmsnorm_eps)
            ek = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wk"])
            ev = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wv"])
            x = x + cross_attention_block(h, (ek, ev), lp["cross"], cfg,
                                          positions=positions)
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            return x + mlp_block(h, lp["mlp"], cfg)

        body = _maybe_remat(body, remat)
        for lp in unstack_layers(params["layers"]):
            x = body(x, lp)
        return rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)

    def _encdec_prefill(self, params, x: torch.Tensor,
                        enc_out: torch.Tensor, kv_chunk: int,
                        extra_cache: int):
        """The decoder prefill over x (B, S, D), positions ``arange(S)``:
        causal self-attention, then cross-attention to ``enc_out @
        cross.wk / wv``, each through the flash kernel under
        ``use_kernel``. Returns (x after the final norm, the cache: every
        layer's self K/V and encoder K/V)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        cl = self.cache_len(S)
        flash = flash_mha if self.use_kernel else None
        kvs, cks, cvs = [], [], []
        for lp in unstack_layers(params["layers"]):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            q, k, v = attn_project_qkv(h, lp["attn"], cfg, positions)
            o = self._prefill_attention(q, k, v, positions, causal=True,
                                        window=None, softcap=None,
                                        kv_chunk=kv_chunk)
            x = x + attn_out(o, lp["attn"])
            h = rmsnorm(x, lp["ln_x"], cfg.rmsnorm_eps)
            ek = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wk"])
            ev = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wv"])
            x = x + cross_attention_block(h, (ek, ev), lp["cross"], cfg,
                                          positions=positions, flash=flash)
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + mlp_block(h, lp["mlp"], cfg)
            kvs.append(_collect_kv(k, v, cl, positions, self.dtype,
                                   self.kv_quant))
            cks.append(ek.to(self.dtype))
            cvs.append(ev.to(self.dtype))
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {"attn": _pad_kv(_stack_kv(kvs), extra_cache, cfg),
                   "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs)}

    # -- entry points ---------------------------------------------------------------
    def _with_prefix(self, params, batch) -> torch.Tensor:
        """The embedded tokens, behind the vlm family's ``patch_embed``
        (B, n_frontend_tokens, D) prefix."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.family == "vlm":
            x = torch.cat([batch["patch_embed"].to(self.dtype), x], dim=1)
        return x

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *,
                remat: str = "none", kv_chunk: int = 1024):
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels``, (B, S); labels below 0 are masked; ``patch_embed`` for
        vlm, whose prefix positions get no logits; ``frame_embed`` for
        audio). Returns (loss, {"loss": loss}); with moe the loss adds
        ``0.01 * aux_lb / L + 1e-3 * aux_z / L`` and the metrics keep the
        cross-entropy as ``loss`` beside ``aux_lb``, as the reference's.
        ``remat`` is ``none``, ``dots`` (matmul outputs saved, the rest
        recomputed) or ``full`` (each layer recomputed in the
        backward)."""
        family = self._family()
        cfg = self.cfg
        x = self._with_prefix(params, batch)
        n_front = x.shape[1] - batch["tokens"].shape[1]
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        aux = None
        if family in ("dense", "moe", "vlm"):
            x, aux = self._decoder_stack(params, x, positions, remat=remat,
                                         kv_chunk=kv_chunk)
        elif family == "ssm":
            x, _ = self._ssm_stack(params, x, remat=remat,
                                   use_kernel=False)
        elif family == "hybrid":
            x = self._hybrid_stack(params, x, positions, remat=remat,
                                   kv_chunk=kv_chunk)
        else:  # audio
            enc_out = self._encode(params, batch["frame_embed"],
                                   remat=remat)
            x = self._encdec_decoder(params, x, enc_out, positions,
                                     remat=remat, kv_chunk=kv_chunk)
        loss = softmax_xent(self._logits(params, x[:, n_front:]),
                            batch["labels"])
        metrics = {"loss": loss}
        if cfg.moe is not None:
            loss = loss + 0.01 * aux["aux_lb"] / cfg.n_layers \
                + 1e-3 * aux["aux_z"] / cfg.n_layers
            metrics["aux_lb"] = aux["aux_lb"]
        return loss, metrics

    def prefill(self, params, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 1024, extra_cache: int = 0):
        """Full-sequence forward that also fills a decode cache. Returns
        (last-token logits (B, 1, V_pad), cache). ``batch`` holds
        ``tokens`` (B, S), and ``patch_embed`` for vlm (prefixed: its
        positions come first) or ``frame_embed`` for audio (the encoder's
        input). ``extra_cache`` reserves cache slots for the decode steps
        that follow (serving path); ``kv_chunk`` is the plain attention's
        chunk above ``DENSE_ATTN_MAX_KV`` keys. With ``use_kernel`` each
        attention runs the flash kernel once and each mamba2 layer's SSD
        the intra-chunk kernel once."""
        family = self._family()
        x = self._with_prefix(params, batch)
        if family in ("dense", "moe", "vlm"):
            x, attn_cache = self._dense_prefill(params, x, kv_chunk,
                                                extra_cache)
            cache = {"attn": attn_cache}
        elif family == "ssm":
            x, ssm_cache = self._ssm_stack(params, x)
            cache = {"ssm": ssm_cache}
        elif family == "hybrid":
            x, cache = self._hybrid_prefill(params, x, kv_chunk,
                                            extra_cache)
        else:  # audio
            enc_out = self._encode(params, batch["frame_embed"],
                                   use_kernel=self.use_kernel)
            x, cache = self._encdec_prefill(params, x, enc_out, kv_chunk,
                                            extra_cache)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, cur):
        """One decode step. tokens (B, 1); ``cur`` is the position of the
        tokens (an int; unused by the ssm layers; for vlm it counts the
        prefix). Returns (logits (B, 1, V_pad), new cache); the given
        cache is not modified."""
        family = self._family()
        x = self._embed(params, tokens, pos0=int(cur))
        new_cache = dict(cache)
        if family == "ssm":
            x, new_cache["ssm"] = self._ssm_stack(params, x, cache)
        elif family == "hybrid":
            x, new_cache = self._hybrid_decode(params, cache, x, int(cur))
        else:
            x, new_cache["attn"] = self._dense_decode(params, cache, x,
                                                      int(cur))
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


def _kv_cache(n: int, slots: int, *, batch: int, kv: int, dh: int, dtype,
              device, quant: bool) -> Dict[str, torch.Tensor]:
    """Empty K/V caches of ``n`` layers (or applications): k/v (n, batch,
    slots, kv, dh) zeros (int8 with ``quant``, beside fp32 zero
    ``k_scale``/``v_scale`` (n, batch, slots, kv)), pos (n, slots) all
    -1."""
    shape = (n, batch, slots, kv, dh)
    kv_dtype = torch.int8 if quant else dtype
    c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
         "v": torch.zeros(shape, dtype=kv_dtype, device=device),
         "pos": torch.full((n, slots), -1, dtype=torch.int32,
                           device=device)}
    if quant:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device)
    return c


def _ssm_cache(cfg, L: int, batch: int, dtype, device
               ) -> Dict[str, torch.Tensor]:
    """Zeroed mamba2 states of ``L`` layers: the fp32 SSM state and the
    conv state."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    nheads = inner // s.head_dim
    conv_dim = inner + 2 * s.n_groups * s.d_state
    return {"state": torch.zeros((L, batch, nheads, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((L, batch, conv_dim, s.d_conv - 1),
                                dtype=dtype, device=device)}


def _ssm_olds(cache, L: int) -> List[Any]:
    """Each layer's (state, conv) from ``cache``; (None, None) for each of
    the ``L`` layers of a prefill (``cache`` None)."""
    if cache is None:
        return [(None, None)] * L
    return list(zip(cache["ssm"]["state"].unbind(0),
                    cache["ssm"]["conv"].unbind(0)))


def _stack_kv(kvs: List[Dict[str, torch.Tensor]]
              ) -> Dict[str, torch.Tensor]:
    """Per-layer K/V caches (with their scales, where quantized) stacked
    on a leading layer axis."""
    return {n: torch.stack([c[n] for c in kvs]) for n in kvs[0]}


def _collect_kv(k, v, cl, positions, dtype, quant: bool
                ) -> Dict[str, torch.Tensor]:
    """Prefill-path cache slice of one layer: the last ``cl`` positions,
    int8 with their scales (``quantize_kv``) under ``quant``."""
    out = {"pos": positions[0, -cl:].to(torch.int32)}
    if quant:
        (out["k"], out["k_scale"]), (out["v"], out["v_scale"]) = (
            quantize_kv(k[:, -cl:]), quantize_kv(v[:, -cl:]))
    else:
        out.update(k=k[:, -cl:].to(dtype), v=v[:, -cl:].to(dtype))
    return out


def _pad_kv(attn_cache: Dict[str, torch.Tensor], extra: int, cfg
            ) -> Dict[str, torch.Tensor]:
    """Right-pad prefilled KV caches (k/v (L, B, cl, Kv, Dh), pos (L, cl),
    and the scales (L, B, cl, Kv) where quantized) with ``extra`` empty
    slots (pos -1, zero k/v and scales) so decode can append. No-op for
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
    for name in ("k_scale", "v_scale"):
        if name in attn_cache:
            out[name] = F.pad(attn_cache[name], (0, 0, 0, extra))
    out["pos"] = F.pad(attn_cache["pos"], (0, extra), value=-1)
    return out
