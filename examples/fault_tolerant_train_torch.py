"""End-to-end driver: train a ~small LM for a few hundred steps under
LogAct governance, with a mid-run executor crash and semantic recovery.

Everything the paper promises is on display:
  * every train chunk is an intention, logged + voted BEFORE it runs;
  * checkpoints are log-anchored (manifest carries the bus position);
  * an injected executor crash leaves a committed-but-unexecuted chunk;
  * a replacement executor announces a reboot Result; the Driver probes
    the environment and rolls forward — no chunk runs twice.

The port's copy of ``examples/fault_tolerant_train.py``, on
``repro_torch``; ``--device`` (default ``cuda``) goes to ``build_env``,
which raises without CUDA unless ``--device cpu`` is given.

Run: PYTHONPATH=src python examples/fault_tolerant_train_torch.py
(on the card; --device cpu runs on the CPU; pass --steps 48 for a
shorter run)
"""
import argparse
import tempfile

from repro_torch.configs.base import get_config, smoke
from repro_torch.core.acl import BusClient
from repro_torch.core.bus import MemoryBus
from repro_torch.core.executor import Executor
from repro_torch.core.introspect import (TRACE_TYPES, summarize_bus,
                                         trace_intents)
from repro_torch.core.recovery import committed_unexecuted
from repro_torch.core.voter import RuleVoter, STANDARD_RULES
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.train_step import StepConfig
from repro_torch.train.trainer import (InjectedCrash, TRAIN_HANDLERS,
                                       build_env, build_training_agent)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = smoke(get_config(args.arch), vocab=256)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        env = build_env(
            cfg,
            OptimizerConfig(lr=3e-3, warmup_steps=10,
                            total_steps=args.steps),
            StepConfig(remat="none"),
            DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8),
            ckpt_dir, device=args.device)
        bus = MemoryBus()
        agent = build_training_agent(env, total_steps=args.steps,
                                     steps_per_intention=8, ckpt_every=32,
                                     bus=bus)
        agent.add_voter(RuleVoter(BusClient(bus, "rv", "voter"),
                                  rules=STANDARD_RULES), from_tail=False)
        agent.set_policy("decider", {"mode": "first_voter"})

        # crash the executor process partway through
        env.crash_after_steps = args.steps // 2 + 3
        agent.send_mail(f"train for {args.steps} steps")
        try:
            agent.run_until_idle(max_rounds=10 ** 6)
        except InjectedCrash:
            print(f"!! executor died at step {env.step} "
                  f"(chunk committed, no result)")
        pend = committed_unexecuted(bus)
        print(f"   committed-but-unexecuted intents on the log: "
              f"{[p['intent_id'] for p in pend]}")

        # standby executor takes over on the same bus + durable env
        agent.executor = Executor(BusClient(bus, "executor-standby",
                                            "executor"),
                                  env=env, handlers=TRAIN_HANDLERS,
                                  announce_reboot=True)
        agent.run_until_idle(max_rounds=10 ** 6)

        losses = [t.result["value"]["loss"]
                  for t in trace_intents(bus.read(0, types=TRACE_TYPES))
                  if t.kind == "train_chunk" and t.result
                  and t.result.get("ok")]
        evals = [t.result["value"]["eval_loss"]
                 for t in trace_intents(bus.read(0, types=TRACE_TYPES))
                 if t.kind == "eval" and t.result and t.result.get("ok")]
        s = summarize_bus(bus)
        print(f"\ntrained to step {env.step}/{args.steps} "
              f"(ckpts at {env.ckpts.list_steps()})")
        print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f} "
              f"eval={evals[-1] if evals else float('nan'):.3f}")
        print(f"log: {s['tail']} entries / {s['total_bytes'] / 1e3:.1f} KB; "
              f"{s['n_committed']} commits, {s['n_aborted']} aborts")
        assert env.step == args.steps
        assert losses[-1] < losses[0], "loss should decrease"
        print("OK: recovered run reached target; loss decreased")


if __name__ == "__main__":
    main()
