"""Gradient compression, the port of ``optim/compression.py``: per-tensor
int8 quantization with error feedback.

Gradients are quantized to int8 (+ an fp32 scale) and dequantized before
the optimizer update; the quantization residual is carried in an
error-feedback buffer so that the compression is unbiased over time
(EF-SGD style). ``torch.round`` rounds halves to even, as ``jnp.round``
does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.params import tree_map


def ef_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (compressed-and-dequantized grads, new error buffers).

    The returned grads equal Q(g + e) with e' = (g + e) - Q(g + e).
    """
    def one(g, e):
        g = g.float() + e
        q, s = quantize(g)
        deq = dequantize(q, s)
        return deq, g - deq

    out = tree_map(one, grads, error)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))
