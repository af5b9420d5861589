"""The port's copies of the examples (``examples/quickstart_torch.py``,
``examples/fault_tolerant_train_torch.py``,
``examples/swarm_serve_torch.py``) against the reference's, on the CPU.

The quickstart (pure governance) prints the same lines in both packages.
The swarm example (three static serving agents on smoke mixtral_8x7b,
swept by a ``Supervisor``) prints the same lines when both sides' agents
hold one numpy tree of parameters (each example module's
``build_serving_agent`` wrapped), apart from each agent's ``health=``
verdict: that is a latency verdict (``health_check`` compares intent
latencies on the wall clock, and the reference's first batch includes
its jit compilation), so it is masked on both sides.
The fault-tolerant run (smoke qwen3_4b, 48 steps, the executor killed at
step 27, a standby executor's reboot Result, probe and roll forward)
starts both sides from one numpy tree, the reference's initial
parameters (each example module's ``build_env`` wrapped; the port's
through ``params_from_numpy``), and holds equal the pending intent after
the crash (its sequence number: the Driver's id is random), the crash
step, the final step, the checkpoints, the log's entries and its
commit/abort counts; every step's loss and the evals to ``LOSS_RTOL``
(rtol 1e-4, the trainer tests'). The training and the swarm
examples, like the launchers, raise without CUDA unless ``--device cpu``
is given.
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
import _torch_trainer_parity as tparity
from repro.core.introspect import trace_intents as jax_trace_intents
from repro_torch.core import trace_intents
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STEPS = 48


def _load(name):
    """``examples/<name>.py`` as a module (its top level runs)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_prints_what_the_reference_prints(capsys):
    capsys.readouterr()
    _load("quickstart")
    want = capsys.readouterr().out
    _load("quickstart_torch")
    assert capsys.readouterr().out == want
    assert "final balance: 135  (expected 135)" in want


def _run(monkeypatch, capsys, name, finish, argv):
    """The example's ``main`` on ``argv``; ``finish`` sets the initial
    parameters on the env its ``build_env`` builds. Returns the printed
    lines with the Driver's random id masked, and the agent."""
    module = _load(name)
    build_env, build_agent = module.build_env, module.build_training_agent
    agents = []

    def env_with_params(*args, **kw):
        env = build_env(*args, **kw)
        finish(env)
        return env

    def recorded(*args, **kw):
        agents.append(build_agent(*args, **kw))
        return agents[-1]
    monkeypatch.setattr(module, "build_env", env_with_params)
    monkeypatch.setattr(module, "build_training_agent", recorded)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    module.main()
    out = re.sub(r"'driver-[0-9a-f]+-", "'driver-*-",
                 capsys.readouterr().out)
    return out.splitlines(), agents[0]


def _values(trace, bus, kind, key):
    return [x for t in trace(bus.read(0)) if t.kind == kind and t.result
            and t.result.get("ok")
            for x in np.atleast_1d(t.result["value"][key]).tolist()]


def test_fault_tolerant_train_matches_the_reference(monkeypatch, capsys):
    _, _, jparams, _ = parity.setup("qwen3_4b", vocab=256)
    want, jagent = _run(
        monkeypatch, capsys, "fault_tolerant_train",
        lambda env: setattr(env, "state", env.init_state(
            jax.tree.map(jnp.asarray, jparams))),
        ["--steps", str(STEPS)])
    got, agent = _run(
        monkeypatch, capsys, "fault_tolerant_train_torch",
        lambda env: setattr(env, "state", env.init_state(
            params_from_numpy(jparams, "cpu"))),
        ["--steps", str(STEPS), "--device", "cpu"])
    loss_line = [i for i, line in enumerate(want)
                 if line.startswith("loss: ")]
    log_line = [i for i, line in enumerate(want) if line.startswith("log: ")]
    assert loss_line and log_line and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in log_line:  # the KB hold float reprs of the losses
            g, w = (re.sub(r"/ \S+ KB", "/ KB", x) for x in (g, w))
        if i not in loss_line:
            assert g == w
    assert want[0] == f"!! executor died at step {STEPS // 2 + 3} (chunk " \
        "committed, no result)"
    assert want[1] == ("   committed-but-unexecuted intents on the log: "
                       "['driver-*-i3']")
    assert want[-1] == "OK: recovered run reached target; loss decreased"
    assert agent.executor.env.step == jagent.executor.env.step == STEPS
    for kind, key in (("train_chunk", "losses"), ("eval", "eval_loss")):
        losses = _values(trace_intents, agent.bus, kind, key)
        want_losses = _values(jax_trace_intents, jagent.bus, kind, key)
        assert len(losses) == len(want_losses) > 0
        np.testing.assert_allclose(losses, want_losses,
                                   rtol=tparity.LOSS_RTOL, atol=0)


def test_without_cuda_the_training_example_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    module = _load("fault_tolerant_train_torch")
    monkeypatch.setattr(sys, "argv", ["fault_tolerant_train_torch",
                                      "--steps", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main()


def _swarm(monkeypatch, capsys, name, params, argv):
    """The swarm example's ``main`` with every serving agent it builds
    holding ``params``; the printed lines, the health verdicts masked."""
    module = _load(name)
    build = module.build_serving_agent

    def with_params(*args, **kw):
        agent = build(*args, **kw)
        agent.executor.env.params = params
        return agent
    monkeypatch.setattr(module, "build_serving_agent", with_params)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    module.main()
    return re.sub(r"health=\S+", "health=*",
                  capsys.readouterr().out).splitlines()


def test_swarm_serve_prints_what_the_reference_prints(monkeypatch, capsys):
    _, _, jparams, tparams = parity.setup("mixtral_8x7b", vocab=256)
    want = _swarm(monkeypatch, capsys, "swarm_serve", jparams, [])
    got = _swarm(monkeypatch, capsys, "swarm_serve_torch", tparams,
                 ["--device", "cpu"])
    assert got == want
    assert want[-2:] == ["served 12 requests across 3 agents", "OK"]
    assert len(want) == 6 and all("health=*" in line for line in want[1:4])


def test_without_cuda_the_swarm_example_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = _load("swarm_serve_torch")
    monkeypatch.setattr(sys, "argv", ["swarm_serve_torch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main()
