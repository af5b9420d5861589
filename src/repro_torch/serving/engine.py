"""Continuous-batching decode engine over the paged KV pool.

``PagedEngine`` owns the model params, a ``KVPool`` and two device
functions:

* **prefill** — one sequence at a time, right-padded to a page-multiple
  bucket. Pad positions are pushed to ``PAD_POS`` so the causal mask
  (``pos_k <= pos_q``) hides pad keys from real queries without
  NaN-producing fully-masked rows. Returns the per-layer post-RoPE K/V
  (scattered into the pool's pages) and the first generated token.
  Prefill attention is plain PyTorch (``models.layers.attention``), as
  the reference computes it outside any kernel.

* **decode step** — ONE token for EVERY in-flight sequence at once, fixed
  ``(max_batch, max_pages_per_seq)`` shapes. Each lane embeds its last
  token at its own position; per layer, the new K/V is written into the
  lane's pool slot first (inactive lanes write to the null page), then the
  lane attends over its block table with paged attention with length
  ``ctx + 1``. New sequences are admitted into free lanes *between* steps
  — continuous batching.

The paged attention runs as the hand-written CUDA kernel
(``kernels.paged_attention.paged_attention``) with ``use_kernel=True``,
the default; CPU tensors take its plain version inside the same wrapper.
``use_kernel=False`` calls the plain version directly, on any device (the
reference run that the kernel's tokens are held against on the card).

Scope: the dense decoder family without sliding windows or frontend
tokens (asserted in ``__init__``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.paged_attention import paged_attention, paged_attention_plain
from ..models.layers import (attention, attn_out, attn_project_qkv,
                             mlp_block, rmsnorm)
from ..models.model import Model
from ..models.params import init_params, unstack_layers
from .kv_pool import KVPool

PAD_POS = 1 << 28  # pad-token position: causally invisible to real queries


@dataclass
class Sequence:
    """Host-side state of one in-flight request."""

    req_id: str
    prompt_len: int
    max_new_tokens: int
    tenant: str = "default"
    lane: int = -1
    tokens: List[int] = field(default_factory=list)  # generated so far

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class PagedEngine:
    def __init__(self, cfg: ArchConfig, *, max_batch: int = 8,
                 num_pages: int = 128, page_size: int = 16,
                 params: Any = None, seed: int = 0,
                 use_kernel: bool = True,
                 max_pages_per_seq: Optional[int] = None,
                 device=None):
        assert cfg.family == "dense", "paged serving: dense decoders only"
        assert cfg.window is None and not cfg.local_global_pattern, \
            "paged serving does not support sliding-window attention"
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, dtype=torch.float32)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self._layers = unstack_layers(params["layers"])
        self.max_batch = max_batch
        self.use_kernel = use_kernel
        self.pool = KVPool(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                           num_pages=num_pages, page_size=page_size,
                           device=self.device)
        # widest block table any sequence may hold — the decode step's
        # fixed gather width (and so its cost): bound it to the actual
        # per-request budget instead of the whole pool when known
        self.max_pages_per_seq = min(num_pages - 1,
                                     max_pages_per_seq or (num_pages - 1))
        self.seqs: Dict[str, Sequence] = {}      # in-flight, keyed by req_id
        self.lanes: List[Optional[str]] = [None] * max_batch
        self.n_steps = 0

    # -- device functions ----------------------------------------------------
    def _attend(self, q, k_pages, v_pages, block_tables, context_lens):
        cfg = self.cfg
        fn = paged_attention if self.use_kernel else paged_attention_plain
        return fn(q, k_pages, v_pages, block_tables, context_lens,
                  scale=cfg.attn_logit_scale, softcap=cfg.attn_softcap)

    def _tensor(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor, true_len: int):
        """tokens (1, s_pad) right-padded. Returns (k (L, s_pad, Kv, Dh),
        v, first_token int)."""
        cfg = self.cfg
        model = self.model
        params = self.params
        s_pad = tokens.shape[1]
        # pad keys get position PAD_POS: masked from real queries by the
        # causal rule pos_k <= pos_q; pad *queries* still see real keys so
        # no row is fully masked (softmax stays NaN-free), and their
        # outputs are simply never read.
        ar = torch.arange(s_pad, device=self.device)
        positions = torch.where(ar < true_len, ar, PAD_POS)[None]
        x = model._embed(params, tokens)
        ks, vs = [], []
        for lp in self._layers:
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            q, k, v = attn_project_qkv(h, lp["attn"], cfg, positions)
            o = attention(q, k, v, pos_q=positions, pos_k=positions,
                          causal=True, window=None,
                          softcap=cfg.attn_softcap,
                          scale=cfg.attn_logit_scale)
            x = x + attn_out(o, lp["attn"])
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + mlp_block(h, lp["mlp"], cfg)
            ks.append(k[0])
            vs.append(v[0])
        x = rmsnorm(x, params["final_norm"], cfg.rmsnorm_eps)
        last = x[:, true_len - 1:true_len]
        logits = model._logits(params, last)            # (1, 1, V)
        tok = int(torch.argmax(logits[0, 0]))
        return torch.stack(ks), torch.stack(vs), tok

    @torch.no_grad()
    def _decode_step(self, tokens, positions, block_tables, slot_pages,
                     slot_offs, attn_lens) -> torch.Tensor:
        """One token for every lane, writing the arenas in place.

        tokens/positions/slot_pages/slot_offs: (B,) int64; attn_lens (B,)
        and block_tables (B, max_pages) int32. Inactive lanes carry
        attn_len 0 and slots on the null page. Returns next_tokens (B,)."""
        cfg = self.cfg
        model = self.model
        k_arena, v_arena = self.pool.k, self.pool.v
        x = model._embed(self.params, tokens[:, None], pos0=positions)
        pos2d = positions[:, None]
        for li, lp in enumerate(self._layers):
            h = rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps)
            q, k, v = attn_project_qkv(h, lp["attn"], cfg, pos2d)
            # write each lane's new K/V into its page slot BEFORE attending
            # (inactive lanes all hit the null page, never read)
            ka, va = k_arena[li], v_arena[li]
            ka[slot_pages, slot_offs] = k[:, 0]
            va[slot_pages, slot_offs] = v[:, 0]
            o = self._attend(q[:, 0].contiguous(), ka, va, block_tables,
                             attn_lens)
            x = x + attn_out(o[:, None], lp["attn"])
            h = rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps)
            x = x + mlp_block(h, lp["mlp"], cfg)
        x = rmsnorm(x, self.params["final_norm"], cfg.rmsnorm_eps)
        logits = model._logits(self.params, x)           # (B, 1, V)
        return torch.argmax(logits[:, 0], dim=-1)

    # -- admission -----------------------------------------------------------
    @property
    def n_inflight(self) -> int:
        return len(self.seqs)

    @property
    def n_free_lanes(self) -> int:
        return self.lanes.count(None)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        total = prompt_len + max_new_tokens
        return (self.n_free_lanes > 0
                and self.pool.pages_needed(total) <= self.max_pages_per_seq
                and self.pool.can_admit(total))

    def admit(self, req_id: str, prompt_tokens, max_new_tokens: int,
              tenant: str = "default") -> bool:
        """Prefill + join the in-flight batch. False = no capacity (the
        caller reports it denied; the scheduler requeues)."""
        prompt = np.asarray(prompt_tokens, np.int64)
        plen = len(prompt)
        if req_id in self.seqs or not self.can_admit(plen, max_new_tokens):
            return False
        lane = self.lanes.index(None)
        self.pool.allocate(req_id, plen + max_new_tokens)
        # bucket the pad length to page multiples
        s_pad = max(self.pool.page_size,
                    self.pool.pages_needed(plen) * self.pool.page_size)
        toks = np.zeros((1, s_pad), np.int64)
        toks[0, :plen] = prompt
        ks, vs, tok = self._prefill(self._tensor(toks, torch.long), plen)
        self.pool.write_prefill(req_id, ks, vs, plen)
        seq = Sequence(req_id=req_id, prompt_len=plen,
                       max_new_tokens=max_new_tokens, tenant=tenant,
                       lane=lane, tokens=[tok])
        self.seqs[req_id] = seq
        self.lanes[lane] = req_id
        return True

    def _retire(self, req_id: str) -> Sequence:
        seq = self.seqs.pop(req_id)
        self.lanes[seq.lane] = None
        self.pool.free(req_id)
        return seq

    # -- the continuous-batching step ---------------------------------------
    def step(self) -> List[Sequence]:
        """One decode step across all lanes; returns sequences finished by
        this step (already retired from their lanes/pool pages)."""
        # sequences admitted with max_new_tokens == 1 finish at prefill
        done = [r for r, s in self.seqs.items() if s.finished]
        active = [r for r in self.lanes if r is not None
                  and not self.seqs[r].finished]
        if active:
            self.n_steps += 1
            ids = list(self.lanes)  # lane-ordered, None for free lanes
            tokens = np.zeros(self.max_batch, np.int64)
            for i, r in enumerate(ids):
                if r is not None and not self.seqs[r].finished:
                    tokens[i] = self.seqs[r].tokens[-1]
                elif r is not None:
                    ids[i] = None  # finished at prefill: don't decode
            ctx = self.pool.context_lens(ids)
            amask = np.asarray([r is not None for r in ids])
            sp, so = self.pool.slots(ids)
            bt = self.pool.block_table(ids, self.max_pages_per_seq)
            nxt = self._decode_step(
                self._tensor(tokens, torch.long),
                self._tensor(ctx, torch.long),
                self._tensor(bt, torch.int32),
                self._tensor(sp, torch.long), self._tensor(so, torch.long),
                self._tensor(ctx + amask, torch.int32)).cpu().numpy()
            for i, r in enumerate(ids):
                if r is None:
                    continue
                self.pool.advance(r)
                self.seqs[r].tokens.append(int(nxt[i]))
                if self.seqs[r].finished:
                    done.append(r)
        return [self._retire(r) for r in done]

    def stats(self) -> Dict[str, Any]:
        return {"n_inflight": self.n_inflight, "n_steps": self.n_steps,
                **self.pool.stats()}
