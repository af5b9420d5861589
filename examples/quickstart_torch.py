"""Quickstart: a LogAct agent in ~40 lines.

The agent is a state machine playing a typed shared log: the Driver
proposes intentions, Voters stamp them, the Decider commits/aborts, the
Executor acts — and the whole history is auditable on the bus.

The port's copy of ``examples/quickstart.py``: the same agent on
``repro_torch.core``.

Run: PYTHONPATH=src python examples/quickstart_torch.py
"""
from repro_torch.core import (LogActAgent, MemoryBus, ScriptPlanner,
                              BusClient, RuleVoter, STANDARD_RULES,
                              summarize_bus, trace_intents)

bus = MemoryBus()
env = {"balance": 100}


def deposit(args, env):
    env["balance"] += args["amount"]
    return {"balance": env["balance"]}


planner = ScriptPlanner([
    {"intent": {"kind": "deposit", "args": {"amount": 25}}},
    {"intent": {"kind": "delete_checkpoint", "args": {}}},  # will be blocked
    {"intent": {"kind": "deposit", "args": {"amount": 10}}},
    {"done": True, "note": "all done"},
])

agent = LogActAgent(bus=bus, planner=planner, env=env,
                    handlers={"deposit": deposit})
agent.add_voter(RuleVoter(BusClient(bus, "rule-voter", "voter"),
                          rules=STANDARD_RULES), from_tail=False)
agent.set_policy("decider", {"mode": "first_voter"})

agent.send_mail("please make the deposits")
agent.run_until_idle()

print(f"final balance: {env['balance']}  (expected 135)")
print("\naudit trail (every action visible, stoppable, recoverable):")
for t in trace_intents(bus.read(0)):
    res = "-" if t.result is None else ("ok" if t.result["ok"] else "err")
    print(f"  {t.kind:20s} votes={len(t.votes)} decision={t.decision:6s} "
          f"result={res}")
s = summarize_bus(bus)
print(f"\nlog: {s['tail']} entries, {s['total_bytes']} bytes, "
      f"{s['n_committed']} committed / {s['n_aborted']} aborted")
assert env["balance"] == 135
