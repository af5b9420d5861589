"""Parameter trees for the port: plain nested dicts of tensors.

The trees carry the same nested keys and the same einsum layouts as the
value tree of the reference's ``split_params`` (``wq (L, D, H, Dh)``,
``wo (L, H, Dh, D)``, ``embed (V_pad, D)``, ...), never ``nn.Linear``'s
transposed layouts, so one set of values runs on both sides.

* ``params_from_numpy`` carries a tree of numpy arrays (for example the
  reference's parameters, converted leaf by leaf) into torch losslessly,
  and ``params_to_numpy`` carries a tree of tensors back.
* ``tree_map`` / ``tree_leaves`` walk such trees (and the optimizers'
  state trees) in the order of JAX's dict flattening: sorted keys.
* ``init_params`` is the port's own initializer, for all six families.
  It follows the reference's rule: normal times ``1/sqrt(shape[-2])``
  (so ``wq``'s scale comes from ``H``, not ``D``), the embedding at scale
  1.0, norms at zero; mamba's ``conv_w`` at scale 0.5, ``A_log`` and
  ``dt_bias`` at zero, ``D`` at one; learned positions (``pos_embed``,
  the encoder's ``enc_pos``) at scale 0.02. The moe family's layers hold
  ``moe`` (router, experts and shared experts) where the dense and vlm
  families' hold ``mlp``; the hybrid family adds ``shared``, one
  attention+MLP block with a leading axis of 1; the audio family adds
  ``enc_layers`` and ``enc_pos``, and its decoder layers hold ``ln_x``
  and ``cross``. Its numbers differ from the reference's (another
  generator); only the rule and the tree are the same.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig


def padded_vocab(vocab: int) -> int:
    """Vocab padded to a multiple of 256 (the reference's ``vocab_pad``)."""
    return -(-vocab // 256) * 256


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dict of array-likes -> same dict of tensors on ``device``
    (dtype kept, values bit-identical)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> same dict of numpy arrays on the host
    (dtype kept, values bit-identical): the inverse of
    ``params_from_numpy``."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` on each leaf of ``tree`` and the matching subtrees of
    ``rest`` (a subtree of ``rest`` may be a dict where ``tree`` has a
    leaf, as Adafactor's ``{"vr", "vc"}`` state beside a parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict, keys sorted at every level (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _normal(shape: Sequence[int], g: torch.Generator, device,
            scale: float = None) -> torch.Tensor:
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
    return torch.randn(tuple(shape), generator=g, device=device,
                       dtype=torch.float32).mul_(scale)


def _zeros(shape: Sequence[int], device) -> torch.Tensor:
    return torch.zeros(tuple(shape), device=device, dtype=torch.float32)


def _init_attn(cfg: ArchConfig, L: int, g, device) -> Dict[str, torch.Tensor]:
    D, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _normal((L, D, H, Dh), g, device),
         "wk": _normal((L, D, Kv, Dh), g, device),
         "wv": _normal((L, D, Kv, Dh), g, device),
         "wo": _normal((L, H, Dh, D), g, device)}
    if cfg.qk_norm:
        p["q_norm"] = _zeros((L, Dh), device)
        p["k_norm"] = _zeros((L, Dh), device)
    return p


def _init_mlp(cfg: ArchConfig, L: int, g, device) -> Dict[str, torch.Tensor]:
    D, F = cfg.d_model, cfg.d_ff
    p = {"w_up": _normal((L, D, F), g, device),
         "w_down": _normal((L, F, D), g, device)}
    if cfg.mlp_gated:
        p["w_gate"] = _normal((L, D, F), g, device)
    return p


def _init_moe(cfg: ArchConfig, L: int, g, device) -> Dict[str, torch.Tensor]:
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {"router": _normal((L, D, E), g, device),
         "w_gate": _normal((L, E, D, F), g, device),
         "w_up": _normal((L, E, D, F), g, device),
         "w_down": _normal((L, E, F, D), g, device)}
    if m.n_shared_experts:
        fs = F * m.n_shared_experts
        p["ws_gate"] = _normal((L, D, fs), g, device)
        p["ws_up"] = _normal((L, D, fs), g, device)
        p["ws_down"] = _normal((L, fs, D), g, device)
    return p


def _init_mamba(cfg: ArchConfig, L: int, g, device
                ) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    D = cfg.d_model
    inner = s.expand * D
    nheads = inner // s.head_dim
    gn = s.n_groups * s.d_state
    return {"w_in": _normal((L, D, 2 * inner + 2 * gn + nheads), g, device),
            "conv_w": _normal((L, inner + 2 * gn, s.d_conv), g, device, 0.5),
            "A_log": _zeros((L, nheads), device),     # log(1): A = -1
            "D": torch.ones((L, nheads), device=device, dtype=torch.float32),
            "dt_bias": _zeros((L, nheads), device),
            "norm": _zeros((L, inner), device),
            "w_out": _normal((L, inner, D), g, device)}


def _init_decoder(cfg: ArchConfig, L: int, g, device
                  ) -> Dict[str, torch.Tensor]:
    """Stacked decoder blocks of the dense, moe and vlm families."""
    D = cfg.d_model
    p = {"ln1": _zeros((L, D), device), "ln2": _zeros((L, D), device),
         "attn": _init_attn(cfg, L, g, device)}
    if cfg.moe is not None:
        p["moe"] = _init_moe(cfg, L, g, device)
    else:
        p["mlp"] = _init_mlp(cfg, L, g, device)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """The fp32 parameter tree of ``cfg`` (reference
    ``Model._init_tree``). ``generator`` must live on ``device``. An
    unknown family raises ``ValueError``."""
    L, D, V = cfg.n_layers, cfg.d_model, padded_vocab(cfg.vocab)
    g = generator
    p: Dict[str, Any] = {"embed": _normal((V, D), g, device, 1.0),
                         "final_norm": _zeros((D,), device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((D, V), g, device)
    if cfg.pos_embedding == "learned":
        p["pos_embed"] = _normal((1 << 15, D), g, device, 0.02)
    if cfg.family in ("dense", "moe", "vlm"):
        p["layers"] = _init_decoder(cfg, L, g, device)
    elif cfg.family in ("ssm", "hybrid"):
        p["layers"] = {"ln1": _zeros((L, D), device),
                       "mamba": _init_mamba(cfg, L, g, device)}
        if cfg.family == "hybrid":  # ONE shared attention+MLP block
            p["shared"] = {"ln1": _zeros((1, D), device),
                           "ln2": _zeros((1, D), device),
                           "attn": _init_attn(cfg, 1, g, device),
                           "mlp": _init_mlp(cfg, 1, g, device)}
    elif cfg.family == "audio":
        Le = cfg.n_enc_layers
        p["enc_layers"] = {"ln1": _zeros((Le, D), device),
                           "ln2": _zeros((Le, D), device),
                           "attn": _init_attn(cfg, Le, g, device),
                           "mlp": _init_mlp(cfg, Le, g, device)}
        p["enc_pos"] = _normal((cfg.enc_seq, D), g, device, 0.02)
        p["layers"] = {"ln1": _zeros((L, D), device),
                       "ln_x": _zeros((L, D), device),
                       "ln2": _zeros((L, D), device),
                       "attn": _init_attn(cfg, L, g, device),
                       "cross": _init_attn(cfg, L, g, device),
                       "mlp": _init_mlp(cfg, L, g, device)}
    else:
        raise ValueError(cfg.family)
    return p


def unstack_layers(tree: Any) -> List[Any]:
    """The layer trees of a stacked ``(L, ...)`` tree (views), each leaf
    ``unbind`` once. Under autograd the L gradients of a leaf then come
    back through one stack, where indexing layer ``i`` of each leaf sends
    every layer a zeroed gradient the size of the whole leaf."""
    per_leaf = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda parts: parts[i], per_leaf)
            for i in range(len(tree_leaves(per_leaf)[0]))]
