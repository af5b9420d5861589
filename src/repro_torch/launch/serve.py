"""Serving launcher: LogAct-governed batched generation, the port of
``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b -n 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

It builds the reference's agent (the static serving agent, a RuleVoter on
``STANDARD_RULES``, the ``first_voter`` decider, requests ``[1+r, 2+r,
3+r]``) and prints the reference's lines. It differs from the reference
in two ways:

* ``main(argv=None)`` parses ``argv`` (None: the command line) and returns
  the agent, so that a caller in the same process can read its log; the
  reference's ``main()`` reads only the command line and returns None.
* ``--device`` (default ``cuda``) goes to ``build_serving_agent``. It is
  resolved first by ``repro_torch.device.resolve_device``, so without
  CUDA the launcher raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..configs.base import ALIASES, ARCH_IDS, get_config, smoke
from ..core.acl import BusClient
from ..core.agent import LogActAgent
from ..core.introspect import TRACE_TYPES, summarize_bus, trace_intents
from ..core.voter import RuleVoter, STANDARD_RULES
from ..device import resolve_device
from ..serving.server import build_serving_agent


def main(argv: Optional[List[str]] = None) -> LogActAgent:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b", choices=ARCH_IDS
                    + list(ALIASES))
    ap.add_argument("-n", "--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain path there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke(cfg, vocab=256)
    agent = build_serving_agent(cfg, max_batch=args.max_batch, device=device)
    agent.add_voter(RuleVoter(BusClient(agent.bus, "rv", "voter"),
                              rules=STANDARD_RULES), from_tail=False)
    agent.set_policy("decider", {"mode": "first_voter"})
    for r in range(args.requests):
        agent.send_mail(f"req-{r}", prompt_tokens=[1 + r, 2 + r, 3 + r])
    agent.run_until_idle(max_rounds=10 ** 6)
    served = 0
    for t in trace_intents(agent.bus.read(agent.bus.trim_base(),
                                          types=TRACE_TYPES)):
        if t.kind == "serve_batch" and t.result and t.result["ok"]:
            served += t.result["value"]["batch"]
            print(f"batch of {t.result['value']['batch']} "
                  f"({t.result['value']['new_tokens']} new tokens each) "
                  f"decision={t.decision}")
    s = summarize_bus(agent.bus)
    print(f"served {served}/{args.requests} requests; log {s['tail']} "
          f"entries / {s['total_bytes'] / 1e3:.1f} KB")
    return agent


if __name__ == "__main__":
    main()
