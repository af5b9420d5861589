"""Training launcher: LogAct-governed training for any assigned arch, the
port of ``launch/train.py``.

Smoke scale by default (the reduced config, vocab 256); ``--full-config``
runs the full architecture on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --steps 32
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 8

It builds the reference's env and agent (AdamW, ``OptimizerConfig``'s
default; remat ``dots`` under ``--full-config``, ``none`` without it; 8
steps an intent, a checkpoint every ``max(steps // 3, 8)``; the log on
``memory``, ``sqlite`` or ``kv`` through ``make_bus``; a RuleVoter, and
with ``--dual-voter`` a StatVoter under ``boolean_OR``) and prints the
reference's lines. It differs from the reference in three ways:

* ``main(argv=None)`` parses ``argv`` (None: the command line) and returns
  the agent, so that a caller in the same process can read its log and
  env; the reference's ``main()`` reads only the command line and returns
  None.
* ``--device`` (default ``cuda``) goes to ``build_env``. It is resolved
  first by ``repro_torch.device.resolve_device``, so without CUDA the
  launcher raises unless ``--device cpu`` is given.
* The data vocabulary is cut to ``DATA_VOCAB`` tokens where the config's
  is larger (every ``--full-config`` arch), with a line that says so. The
  synthetic pipeline builds a dense vocab x vocab fp32 table and argsorts
  it: 92 GB at qwen3_4b's 151,936, more for the argsort's int64 result.
  The model, its padded head and the loss keep the config's vocabulary.
  At smoke scale (vocab 256) nothing is cut.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

from ..configs.base import ALIASES, ARCH_IDS, get_config, smoke
from ..core.acl import BusClient
from ..core.agent import LogActAgent
from ..core.bus import MemoryBus, make_bus
from ..core.introspect import TRACE_TYPES, summarize_bus, trace_intents
from ..core.voter import RuleVoter, StatVoter, STANDARD_RULES
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..optim.optimizer import OptimizerConfig
from ..train.train_step import StepConfig
from ..train.trainer import build_env, build_training_agent

DATA_VOCAB = 4096  # the largest data vocabulary (a 67 MB table)


def main(argv: Optional[List[str]] = None) -> LogActAgent:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b", choices=ARCH_IDS
                    + list(ALIASES))
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture config")
    ap.add_argument("--bus", default="memory",
                    choices=["memory", "sqlite", "kv"])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--dual-voter", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke(cfg, vocab=256)
    data = DataConfig(vocab=min(cfg.vocab, DATA_VOCAB), seq_len=args.seq_len,
                      global_batch=args.global_batch)
    if data.vocab != cfg.vocab:
        print(f"data vocab cut to {data.vocab} from {cfg.vocab} (the "
              f"pipeline's dense vocab x vocab table); the model and its "
              f"loss keep {cfg.vocab}")
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro-train-")
    env = build_env(
        cfg,
        OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        StepConfig(remat="none" if not args.full_config else "dots"),
        data, f"{workdir}/ckpts", device=device)
    bus = (MemoryBus() if args.bus == "memory"
           else make_bus(args.bus, path=f"{workdir}/bus"
                         + (".db" if args.bus == "sqlite" else "")))
    agent = build_training_agent(env, total_steps=args.steps,
                                 steps_per_intention=8,
                                 ckpt_every=max(args.steps // 3, 8), bus=bus)
    agent.add_voter(RuleVoter(BusClient(bus, "rule-voter", "voter"),
                              rules=STANDARD_RULES), from_tail=False)
    if args.dual_voter:
        agent.add_voter(StatVoter(BusClient(bus, "stat-voter", "voter"),
                                  override_for="rule"), from_tail=False)
        agent.set_policy("decider", {"mode": "boolean_OR",
                                     "voter_types": ["rule", "stat"]})
    else:
        agent.set_policy("decider", {"mode": "first_voter"})
    agent.send_mail(f"train {args.arch} for {args.steps} steps")
    agent.run_until_idle(max_rounds=10 ** 6)

    losses = [t.result["value"]["loss"]
              for t in trace_intents(bus.read(bus.trim_base(),
                                              types=TRACE_TYPES))
              if t.kind == "train_chunk" and t.result and t.result["ok"]]
    s = summarize_bus(bus)
    print(f"arch={cfg.arch_id} steps={env.step}/{args.steps} "
          f"ckpts={env.ckpts.list_steps()} workdir={workdir}")
    print(f"loss first={losses[0]:.3f} last={losses[-1]:.3f}; "
          f"log {s['tail']} entries / {s['total_bytes'] / 1e3:.1f} KB "
          f"({s['n_committed']} commits, {s['n_aborted']} aborts)")
    return agent


if __name__ == "__main__":
    main()
