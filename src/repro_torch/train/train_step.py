"""The train step, the port of ``train/train_step.py``.

``make_train_step`` returns ``(init_state, train_step)``;
``train_step(state, batch) -> (state, metrics)`` runs:
  * microbatch gradient accumulation (a loop over ``microbatches`` row
    splits of the batch: the gradients summed then divided, the loss
    averaged, the metrics of the last microbatch); a batch whose rows
    ``microbatches`` does not divide raises a ``ValueError``, as the
    reference's reshape into ``(mb, b // mb, ...)`` refuses it;
  * the remat policy of ``Model.loss_fn`` on every layer;
  * optional int8 + error-feedback gradient compression;
  * the AdamW or Adafactor update, which writes the new parameters into
    ``state["params"]`` (see ``optim.optimizer``).

The gradients come from ``torch.autograd.grad`` on detached copies of the
parameter tensors (same storage), so the state's parameters never carry
``requires_grad`` and no graph outlives the step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.model import Model
from ..models.params import tree_leaves, tree_map
from ..optim import compression
from ..optim.optimizer import OptimizerConfig, make_optimizer


@dataclass(frozen=True)
class StepConfig:
    remat: str = "full"            # none | dots | full
    microbatches: int = 1
    kv_chunk: int = 1024
    compress_grads: bool = False


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    step_cfg: StepConfig):
    opt_init, opt_update = make_optimizer(opt_cfg)
    mb = step_cfg.microbatches

    def init_state(params):
        state = {"params": params, "opt": opt_init(params)}
        if step_cfg.compress_grads:
            state["ef"] = compression.ef_init(params)
        return state

    def value_and_grad(params, batch) -> Tuple[torch.Tensor, Dict, Any]:
        leaf_params = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(leaf_params, batch,
                                          remat=step_cfg.remat,
                                          kv_chunk=step_cfg.kv_chunk)
            flat = torch.autograd.grad(loss, tree_leaves(leaf_params))
        by_id = {id(p): g for p, g in zip(tree_leaves(leaf_params), flat)}
        grads = tree_map(lambda p: by_id[id(p)], leaf_params)
        return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads

    def train_step(state, batch):
        params = state["params"]
        if mb == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % mb:
                raise ValueError(f"microbatches={mb} does not divide the "
                                 f"batch size {b}")
            grads, loss = None, torch.zeros((), dtype=torch.float32,
                                            device=batch["tokens"].device)
            for i in range(mb):
                rows = slice(i * (b // mb), (i + 1) * (b // mb))
                micro = {k: v[rows] for k, v in batch.items()}
                l, metrics, g = value_and_grad(params, micro)
                grads = g if grads is None else tree_map(torch.Tensor.add_,
                                                         grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g.div_(mb), grads)
            loss = loss / mb
        new_state = dict(state)
        if step_cfg.compress_grads:
            grads, new_state["ef"] = compression.compress_grads(
                grads, state["ef"])
        new_params, new_opt, opt_metrics = opt_update(
            params, grads, state["opt"])
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return new_state, metrics

    return init_state, train_step
