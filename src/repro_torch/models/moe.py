"""Mixture-of-Experts, the port of ``models/moe.py``: top-k routing and the
sort-based capacity dispatch.

The dispatch is the reference's sort/scatter formulation (no one-hot
(N, E, C) dispatch tensor):

  1. router logits (fp32) -> top-k experts + weights per token
     (``route``);
  2. flatten the (token, expert) pairs token by token, stable-sort them by
     expert id; rank each pair within its expert from the experts'
     starting offsets; keep the ranks below the capacity C
     (``dispatch_plan``);
  3. scatter the kept pairs' tokens into an (E, C, D) buffer;
  4. three grouped products (E,C,D)x(E,D,F) for gate/up and back;
  5. gather back to token order, weighted-sum the k expert outputs in
     fp32.

Returns (output, aux) where aux carries the load-balance loss
(Switch-style) and the router z-loss, both in fp32.

Which pairs are dropped depends on the order of the top-k experts and on
the stable order of the sort. ``jax.lax.top_k`` returns a token's experts
by descending probability, the lower index first on ties. ``torch.topk``
promises no order on ties on the card, so ``route`` takes the first k of
a stable descending sort (``torch.sort(stable=True)``), which gives the
reference's order on every device. The reference's ``shard`` annotations
(expert parallelism over the mesh) have no counterpart on one card and
are left out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float, cap_min: int = 4) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    c = max(c, cap_min)
    return -(-c // 4) * 4  # round up to a multiple of 4


def route(xf: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (N, D), router (D, E) -> fp32 (logits (N, E), probs (N, E),
    top_w (N, K) renormalised to sum 1, top_e (N, K) int64), the experts
    of a token by descending probability, the lower index first on
    ties."""
    logits = torch.matmul(xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_e


def dispatch_plan(top_e: torch.Tensor, n_experts: int, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The capacity dispatch of the (token, expert) pairs ``top_e``
    (N, K), laid out token by token: (order, the stable sort of the pairs
    by expert id; e_sort, the experts in that order; rank, each sorted
    pair's rank within its expert; keep, rank < cap)."""
    e_flat = top_e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    # each expert's first index in e_sort (sorted), where bincount has no
    # meta kernel for the dry-run's trace
    starts = torch.searchsorted(
        e_sort, torch.arange(n_experts, device=top_e.device,
                             dtype=e_sort.dtype))
    rank = torch.arange(e_flat.numel(), device=top_e.device) - starts[e_sort]
    return order, e_sort, rank, rank < cap


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D). p: router (D,E), w_gate/w_up (E,D,F), w_down (E,F,D),
    optional shared-expert ws_* 2-D matrices."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    N = B * S
    xf = x.reshape(N, D)

    logits, probs, top_w, top_e = route(xf, p["router"], K)

    # -- aux losses (fp32) ----------------------------------------------------
    me = probs.mean(dim=0)                                      # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.full((N * K,), 1.0 / (N * K),
                                         device=x.device))
    aux_lb = E * torch.sum(me * ce)
    aux_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # -- sort-based dispatch ---------------------------------------------------
    C = capacity(N, E, K, m.capacity_factor)
    order, e_sort, rank, keep = dispatch_plan(top_e, E, C)
    t_sort = torch.div(order, K, rounding_mode="floor")  # the pairs' tokens
    # a kept pair's row of the (E*C, D) buffer; a dropped one goes to the
    # spare last row, which no expert reads
    slot = torch.where(keep, e_sort * C + rank, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xf[t_sort])[:E * C].reshape(E, C, D)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y_buf = torch.bmm(h, p["w_down"]).reshape(E * C, D)

    # -- gather back + weighted combine ---------------------------------------
    y_buf = torch.cat([y_buf.float(), y_buf.new_zeros((1, D),
                                                      dtype=torch.float32)])
    y_flat = torch.empty((N * K, D), dtype=torch.float32, device=x.device)
    y_flat = y_flat.index_put((order,), y_buf[slot])
    y = (y_flat.reshape(N, K, D) * top_w[..., None]).sum(dim=1)

    out = y.reshape(B, S, D).to(x.dtype)
    if m.n_shared_experts:
        hs = F.silu(torch.einsum("bsd,df->bsf", x, p["ws_gate"])) \
            * torch.einsum("bsd,df->bsf", x, p["ws_up"])
        out = out + torch.einsum("bsf,fd->bsd", hs, p["ws_down"])
    return out, {"aux_lb": aux_lb, "aux_z": aux_z}
