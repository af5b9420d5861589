"""Swarm serving example: a fleet of LogAct serving agents behind an
AgentKernel, with a Supervisor health-checking the fleet via bus
introspection and a dual-voter quorum guarding prompts.

The port's copy of ``examples/swarm_serve.py``, on ``repro_torch``;
``--device`` (default ``cuda``) goes to ``build_serving_agent``, which
raises without CUDA unless ``--device cpu`` is given.

Run: PYTHONPATH=src python examples/swarm_serve_torch.py
(on the card; --device cpu runs on the CPU)
"""
import argparse

from repro_torch.configs.base import get_config, smoke
from repro_torch.core.acl import BusClient
from repro_torch.core.bus import MemoryBus
from repro_torch.core.introspect import TRACE_TYPES, trace_intents
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.voter import RuleVoter, VoteDecision
from repro_torch.serving.server import build_serving_agent

N_SERVERS = 3


def no_giant_batches(body, pol):
    if body["kind"] == "serve_batch" and len(body["args"]["prompts"]) > 8:
        return VoteDecision(False, "batch too large")
    return None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = smoke(get_config("mixtral_8x7b"), vocab=256)
    agents = {}
    for i in range(N_SERVERS):
        a = build_serving_agent(cfg, bus=MemoryBus(), max_batch=8,
                                agent_id=f"srv{i}", device=args.device)
        a.add_voter(RuleVoter(BusClient(a.bus, f"rv{i}", "voter"),
                              rules=[no_giant_batches]), from_tail=False)
        a.set_policy("decider", {"mode": "first_voter"})
        agents[f"srv{i}"] = a

    # round-robin 12 requests across the fleet
    for r in range(12):
        name = f"srv{r % N_SERVERS}"
        agents[name].send_mail(f"req-{r}",
                               prompt_tokens=[1 + r, 2 + r, 3 + r])
    for a in agents.values():
        a.run_until_idle(max_rounds=100000)

    sup = Supervisor({n: a.bus for n, a in agents.items()})
    view = sup.sweep()
    print("fleet view (supervisor introspection over every AgentBus):")
    total = 0
    for name, s in view["summaries"].items():
        done = s["n_completed"]
        hc = view["health"][name]["verdict"]
        print(f"  {name}: {done} serve batches committed+executed, "
              f"{s['total_bytes']} log bytes, health={hc}")
        for t in trace_intents(agents[name].bus.read(0, types=TRACE_TYPES)):
            if t.kind == "serve_batch" and t.result and t.result["ok"]:
                total += t.result["value"]["batch"]
    print(f"served {total} requests across {N_SERVERS} agents")
    assert total == 12
    print("OK")


if __name__ == "__main__":
    main()
