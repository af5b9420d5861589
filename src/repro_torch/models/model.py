"""The port of ``models/model.py``: the padded vocab, the token embedding
and the (tied) output head, which the paged serving engine uses, and the
static generation path (``init_cache`` / ``prefill`` / ``decode_step``)
for the ssm family (mamba2), which the static serving discipline uses.
The parameter trees are ``models.params.init_params``.

The layer stack is a Python loop over the stacked ``(L, ...)`` layer tree
where the reference runs ``lax.scan``; the caches come back stacked on L
as there. The dense family's static path, the loss and the other
families are not ported yet: their ``prefill`` / ``decode_step`` raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Union

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import ssm as ssm_lib
from .layers import rmsnorm
from .params import layer_slice, padded_vocab


class Model:
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True):
        self.cfg = cfg
        self.dtype = dtype
        # the SSD prefill's intra-chunk kernel (CUDA tensors) or, with
        # False, its plain version on any device (the reference run that
        # the kernel's tokens are held against on the card)
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
            logits[..., cfg.vocab:] = -1e30
        return logits

    def _static_family(self, what: str) -> None:
        if self.cfg.family != "ssm":
            raise NotImplementedError(
                f"Model.{what}: family {self.cfg.family!r} is not ported "
                f"yet (the port's static path serves the ssm family)")

    # -- caches -----------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, device=None
                   ) -> Dict[str, Any]:
        """Zeroed decode cache (reference ``init_cache``); ``seq_len`` is
        unused by the ssm family. ``device=None`` means the card."""
        self._static_family("init_cache")
        cfg, s = self.cfg, self.cfg.ssm
        dev = resolve_device(device)
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
    def _ssm_stack(self, params, x: torch.Tensor, cache=None):
        """The mamba2 layers and the final norm over x (B, S, D): a prefill
        when ``cache`` is None, else one decode step from ``cache``.
        Returns (x, the new per-layer states stacked on L)."""
        cfg = self.cfg
        states, convs = [], []
        for i in range(cfg.n_layers):
            lp = layer_slice(params["layers"], i)
            kw = {} if cache is None else dict(
                ssm_state=cache["ssm"]["state"][i],
                conv_state=cache["ssm"]["conv"][i], decode=True)
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            h, (s_new, c_new) = ssm_lib.mamba2_block(
                h, lp["mamba"], cfg, use_kernel=self.use_kernel, **kw)
            x = x + h
            states.append(s_new)
            convs.append(c_new)
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        return x, {"state": torch.stack(states), "conv": torch.stack(convs)}

    def prefill(self, params, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 1024, extra_cache: int = 0):
        """Full-sequence forward that also fills a decode cache. Returns
        (last-token logits (B, 1, V_pad), cache). ``kv_chunk`` and
        ``extra_cache`` size attention caches; the ssm family has none.
        Each layer's SSD runs the intra-chunk kernel once (``use_kernel``).
        """
        self._static_family("prefill")
        x, ssm_cache = self._ssm_stack(params,
                                       self._embed(params, batch["tokens"]))
        return self._logits(params, x[:, -1:]), {"ssm": ssm_cache}

    def decode_step(self, params, cache, tokens: torch.Tensor, cur):
        """One decode step. tokens (B, 1); ``cur`` (the position) is unused
        by the ssm family. Returns (logits (B, 1, V_pad), new cache); the
        given cache is not modified."""
        self._static_family("decode_step")
        x, ssm_cache = self._ssm_stack(params, self._embed(params, tokens),
                                       cache)
        new_cache = dict(cache)
        new_cache["ssm"] = ssm_cache
        return self._logits(params, x), new_cache
