"""LogAct-integrated trainer, the port of ``train/trainer.py``: the paper's
state machine driving training.

The *environment* is the expensive external state: model/optimizer
tensors on the card, the checkpoint store, the data cursor. The Driver's
*Planner* proposes ``train_chunk`` intentions (a chunk =
``steps_per_intention`` optimizer steps over an explicit data range);
Voters guard them (NaN/loss-anomaly/cursor-monotonicity/LR bounds); the
Executor owns the train step and appends Results carrying metrics.
Checkpoints are log-anchored.

Failure drill: kill the executor mid-run; a new executor announces a
reboot Result; the Driver introspects, probes the environment (checkpoint
store + step counter), and rolls forward without re-training committed
chunks.

The environment lives on the card unless ``build_env`` is given another
device; the seeded initial parameters come from ``init_params`` (the
reference draws them from ``PRNGKey(seed)``: same rule and tree, other
numbers).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.agent import LogActAgent
from ..core.driver import Planner
from ..data.pipeline import DataConfig, TokenPipeline
from ..device import resolve_device
from ..models.model import Model
from ..models.params import init_params
from ..optim.optimizer import OptimizerConfig
from .checkpoint import CheckpointStore
from .train_step import StepConfig, make_train_step


class InjectedCrash(BaseException):
    """Simulates executor process death: NOT caught by the Executor's
    error handling (derives from BaseException), so the committed intent
    is left without a Result — the at-most-once recovery case."""


@dataclass
class TrainEnv:
    model: Model
    pipeline: TokenPipeline
    ckpts: CheckpointStore
    device: torch.device
    state: Any = None
    step: int = 0
    data_cursor: int = 0
    train_step: Optional[Callable] = None
    init_state: Optional[Callable] = None
    lr_scale: float = 1.0
    last_metrics: Dict[str, float] = field(default_factory=dict)
    # crash injection for tests/benchmarks: raises after N more steps
    crash_after_steps: Optional[int] = None

    def ensure_initialized(self, seed: int = 0) -> None:
        if self.state is not None:
            return
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = self.init_state(
            init_params(self.model.cfg, gen, self.device))

    def batch(self, cursor: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch at ``cursor`` as int64 tensors on the
        env's device."""
        b = self.pipeline.batch_at(cursor)
        return {k: torch.from_numpy(b[k]).to(self.device, torch.int64)
                for k in ("tokens", "labels")}


def build_env(cfg: ArchConfig, opt_cfg: OptimizerConfig,
              step_cfg: StepConfig, data_cfg: DataConfig,
              ckpt_root: str, device=None) -> TrainEnv:
    """``device=None`` means the card."""
    model = Model(cfg, dtype=torch.float32)
    pipeline = TokenPipeline(data_cfg)
    init_state, train_step = make_train_step(model, opt_cfg, step_cfg)
    return TrainEnv(model=model, pipeline=pipeline,
                    ckpts=CheckpointStore(ckpt_root),
                    device=resolve_device(device),
                    train_step=train_step, init_state=init_state)


# ---------------------------------------------------------------------------
# Executor handlers (the agent's action vocabulary)
# ---------------------------------------------------------------------------

def h_train_chunk(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    env.ensure_initialized()
    steps = int(args["steps"])
    data_start = int(args.get("data_start", env.data_cursor))
    losses = []
    for i in range(steps):
        if env.crash_after_steps is not None:
            if env.crash_after_steps <= 0:
                env.crash_after_steps = None
                raise InjectedCrash("executor process died mid-chunk")
            env.crash_after_steps -= 1
        env.state, metrics = env.train_step(env.state,
                                            env.batch(data_start + i))
        losses.append(float(metrics["loss"]))
        env.step += 1
    env.data_cursor = data_start + steps
    env.last_metrics = {"loss": losses[-1],
                        "grad_norm": float(metrics["grad_norm"])}
    return {"loss": losses[-1], "losses": losses,
            "grad_norm": float(metrics["grad_norm"]),
            "step": env.step, "data_cursor": env.data_cursor}


def h_eval(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    env.ensure_initialized()
    n = int(args.get("batches", 2))
    tot = 0.0
    with torch.no_grad():
        for i in range(n):
            loss, _ = env.model.loss_fn(env.state["params"],
                                        env.batch(10_000_000 + i))  # held out
            tot += float(loss)
    return {"eval_loss": tot / n, "step": env.step}


def h_save_checkpoint(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    env.ensure_initialized()
    path = env.ckpts.save(env.step, env.state,
                          log_position=int(args.get("log_position", -1)),
                          data_cursor=env.data_cursor)
    return {"checkpoint_step": env.step, "path": path,
            "data_cursor": env.data_cursor}


def h_restore_checkpoint(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    env.ensure_initialized()
    step = int(args["step"]) if "step" in args else env.ckpts.latest()
    if step is None:
        return {"restored": False, "reason": "no checkpoints"}
    env.state, man = env.ckpts.restore(step, env.state)
    env.step = man["step"]
    env.data_cursor = man["data_cursor"]
    return {"restored": True, "step": env.step,
            "data_cursor": env.data_cursor,
            "log_position": man["log_position"]}


def h_probe_state(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    """Exploratory intention for semantic recovery: report environment
    state so the Driver can decide roll-forward vs skip."""
    return {"step": env.step, "data_cursor": env.data_cursor,
            "initialized": env.state is not None,
            "latest_checkpoint": env.ckpts.latest(),
            "checkpoints": env.ckpts.list_steps()}


def h_set_lr(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    env.lr_scale = float(args["lr"])
    return {"lr_scale": env.lr_scale}


def h_delete_checkpoint(args: Dict[str, Any], env: TrainEnv) -> Dict[str, Any]:
    env.ckpts.delete(int(args["step"]), pinned=bool(args.get("pinned")))
    return {"deleted": int(args["step"])}


TRAIN_HANDLERS = {
    "train_chunk": h_train_chunk,
    "eval": h_eval,
    "save_checkpoint": h_save_checkpoint,
    "restore_checkpoint": h_restore_checkpoint,
    "probe_state": h_probe_state,
    "set_lr": h_set_lr,
    "delete_checkpoint": h_delete_checkpoint,
}


# ---------------------------------------------------------------------------
# The Planner ("inference layer") for training
# ---------------------------------------------------------------------------

class TrainPlanner(Planner):
    """Proposes train chunks to a target step count, with periodic
    checkpoints and a final eval. On recovery (executor reboot), probes the
    environment first and resumes from the probe's data cursor — at-most-
    once for every committed chunk."""

    def __init__(self, total_steps: int, steps_per_intention: int = 4,
                 ckpt_every: int = 8):
        self.total = total_steps
        self.chunk = steps_per_intention
        self.ckpt_every = ckpt_every
        self._probing = False

    def propose(self, context: Dict[str, Any]) -> Dict[str, Any]:
        history = context.get("history", [])
        results = [h["body"] for h in history
                   if h.get("role") == "result" and h["body"].get("ok")]
        if context.get("recovering") and not self._probing:
            self._probing = True
            return {"intent": {"kind": "probe_state", "args": {}},
                    "note": "executor rebooted; probing environment state"}
        step, cursor = 0, 0
        for r in results:
            v = r.get("value", {})
            if "step" in v:
                step = max(step, int(v["step"]))
            if "data_cursor" in v:
                cursor = max(cursor, int(v["data_cursor"]))
        self._probing = False
        if step >= self.total:
            if results and "eval_loss" in results[-1].get("value", {}):
                return {"done": True, "note": "target reached + evaled"}
            return {"intent": {"kind": "eval", "args": {"batches": 2}},
                    "note": "final eval"}
        # periodic checkpoint
        last_ckpt = max((int(r["value"]["checkpoint_step"]) for r in results
                         if "checkpoint_step" in r.get("value", {})),
                        default=-1)
        if step - max(last_ckpt, 0) >= self.ckpt_every and step > 0 \
                and last_ckpt < step:
            return {"intent": {"kind": "save_checkpoint", "args": {}},
                    "note": f"checkpoint at step {step}"}
        n = min(self.chunk, self.total - step)
        expected = None
        last_losses = [r["value"]["loss"] for r in results
                       if "loss" in r.get("value", {})]
        if last_losses:
            expected = float(np.median(last_losses[-8:]))
        args = {"steps": n, "data_start": cursor}
        if expected is not None:
            args["expected_loss"] = expected
        return {"intent": {"kind": "train_chunk", "args": args},
                "note": f"train {n} steps from cursor {cursor}"}


def build_training_agent(env: TrainEnv, total_steps: int, *,
                         bus=None, steps_per_intention: int = 4,
                         ckpt_every: int = 8, voters=(),
                         agent_id: str = "trainer") -> LogActAgent:
    planner = TrainPlanner(total_steps, steps_per_intention, ckpt_every)
    return LogActAgent(bus=bus, planner=planner, env=env,
                       handlers=TRAIN_HANDLERS, voters=list(voters),
                       agent_id=agent_id)
