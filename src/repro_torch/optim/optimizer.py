"""Optimizers, the port of ``optim/optimizer.py``: AdamW (fp32 state) and
Adafactor (factored second moment, no momentum, no master copy), plus
global-norm clipping and the warmup-plus-cosine LR schedule.

Plain functions on nested dicts of tensors under ``torch.no_grad()``;
``step`` is an int32 0-d tensor, as in the reference. The arithmetic is
the reference's, operation for operation. The one difference is where the
results live: an update writes the new parameters into the given
parameter tensors and uses the given gradient tensors as its scratch
space, so that a full-width model needs no second copy of either (the
caller's parameter tree *is* the returned one, and its gradients are
spent). Adafactor's update-clipping RMS is taken over the whole stacked
``(L, ...)`` leaf, as in the reference, not per layer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before scaling)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.mul_(scale), grads), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _zero_step(params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: Dict[str, Any]) -> Tuple[Any, Dict[str, Any],
                                                 Dict[str, torch.Tensor]]:
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        u.add_(p, alpha=cfg.weight_decay)
        p.sub_(u.mul_(lr))

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored v for >=2D params; no momentum; no master copy)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Any) -> Dict[str, Any]:
    def init(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}
    return {"v": tree_map(init, params), "step": _zero_step(params)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, params: Any, grads: Any,
                     state: Dict[str, Any]) -> Tuple[Any, Dict[str, Any],
                                                     Dict[str, torch.Tensor]]:
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    beta2 = 1.0 - step.float() ** -0.8

    def upd(p, g, v):
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
            del g2
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                   min=1e-30))
            u = g.mul_(denom.add_(1e-30).rsqrt_())
            nv = {"vr": vr, "vc": vc}
        else:
            nv = {"v": beta2 * v["v"] + (1 - beta2) * g2}
            u = g.mul_(torch.rsqrt(nv["v"] + 1e-30))
        # update clipping (RMS <= 1) + weight decay
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u.div_(torch.clamp(rms, min=1.0))
        u.add_(p, alpha=cfg.weight_decay)
        p.sub_(u.mul_(lr))
        return nv

    new_v = tree_map(upd, params, grads, state["v"])
    return params, {"v": new_v, "step": step}, {"grad_norm": gn, "lr": lr}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(cfg, p, g, s)
    if cfg.name == "adafactor":
        return adafactor_init, lambda p, g, s: adafactor_update(cfg, p, g, s)
    raise ValueError(cfg.name)


def _zero_step(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
