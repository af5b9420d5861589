"""The port's governed trainer against the reference's, on the CPU, over
smoke ``qwen3_4b`` with the same initial parameters on both sides: the
executor-crash drill of ``tests/test_recovery.py`` (crash inside the
second chunk, a rebooted executor, probe and roll forward) and the
governed end to end of ``tests/test_system.py`` (``STANDARD_RULES``, a
log-anchored checkpoint, a final eval). Each run's intents (kinds, args,
decisions), ``env.step``, data cursors and losses are held to the
reference run's. Then the checkpoint integrity and delete-guard tests of
``tests/test_recovery.py``, on a torch env.

Tolerance: losses (and the ``expected_loss`` the planner derives from
them) rtol = 1e-4, as the trajectories of ``test_torch_train.py``;
everything else is exact.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke as jax_smoke  # noqa: E402
from repro.core import acl as jax_acl  # noqa: E402
from repro.core import bus as jax_bus  # noqa: E402
from repro.core import executor as jax_executor  # noqa: E402
from repro.core import introspect as jax_introspect  # noqa: E402
from repro.core import recovery as jax_recovery  # noqa: E402
from repro.core import voter as jax_voter  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.optim import optimizer as jax_optimizer  # noqa: E402
from repro.train import train_step as jax_train_step  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.core import (STANDARD_RULES, Executor,  # noqa: E402
                              MemoryBus, RuleVoter, committed_unexecuted,
                              summarize_bus, trace_intents)
from repro_torch.core.acl import BusClient  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import StepConfig  # noqa: E402
from repro_torch.train.trainer import (TRAIN_HANDLERS,  # noqa: E402
                                       InjectedCrash, build_env,
                                       build_training_agent)

torch.set_num_threads(1)
LOSS_RTOL = 1e-4


class _Side:
    """One package's names for the scenarios."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.MemoryBus = jax_bus.MemoryBus if jax_side else MemoryBus
        self.BusClient = jax_acl.BusClient if jax_side else BusClient
        self.Executor = jax_executor.Executor if jax_side else Executor
        self.RuleVoter = jax_voter.RuleVoter if jax_side else RuleVoter
        self.STANDARD_RULES = (jax_voter.STANDARD_RULES if jax_side
                               else STANDARD_RULES)
        self.trace_intents = (jax_introspect.trace_intents if jax_side
                              else trace_intents)
        self.summarize_bus = (jax_introspect.summarize_bus if jax_side
                              else summarize_bus)
        self.committed_unexecuted = (jax_recovery.committed_unexecuted
                                     if jax_side else committed_unexecuted)
        self.handlers = (jax_trainer.TRAIN_HANDLERS if jax_side
                         else TRAIN_HANDLERS)
        self.InjectedCrash = (jax_trainer.InjectedCrash if jax_side
                              else InjectedCrash)
        self.build_training_agent = (jax_trainer.build_training_agent
                                     if jax_side else build_training_agent)

    def env(self, tmpdir, opt_kw, remat="none"):
        """Smoke qwen3_4b; both sides start from the reference's
        initializer at seed 0."""
        if self.name == "jax":
            cfg = jax_smoke(jax_get_config("qwen3_4b"))
            env = jax_trainer.build_env(
                cfg, jax_optimizer.OptimizerConfig(**opt_kw),
                jax_train_step.StepConfig(remat=remat),
                jax_pipeline.DataConfig(cfg.vocab, 16, 4), tmpdir)
            env.ensure_initialized()
            return env
        cfg = smoke(get_config("qwen3_4b"))
        env = build_env(cfg, OptimizerConfig(**opt_kw),
                        StepConfig(remat=remat),
                        DataConfig(cfg.vocab, 16, 4), tmpdir, device="cpu")
        env.state = env.init_state(params_from_numpy(_jax_init(), "cpu"))
        return env


def _jax_init():
    m = JaxModel(jax_smoke(jax_get_config("qwen3_4b")), dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        split_params(m.init(jax.random.PRNGKey(0)))[0])


def _record(side, bus, env):
    """What the run did: each intent's kind, args, decision and result."""
    trace = []
    for t in side.trace_intents(bus.read(0)):
        res = t.result or {}
        trace.append({"kind": t.kind, "args": t.args,
                      "decision": t.decision, "ok": res.get("ok"),
                      "value": {k: v for k, v in (res.get("value") or {})
                                .items() if k != "path"}})
    return {"trace": trace, "step": env.step, "cursor": env.data_cursor}


def _same(a, b, path=""):
    """Equal, with floats (losses and what derives from them) to
    LOSS_RTOL."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a), set(b))
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=0,
                                   err_msg=path)
    else:
        assert a == b, (path, a, b)


def _crash_drill(side, tmpdir):
    """tests/test_recovery.py::test_executor_crash_and_roll_forward."""
    env = side.env(tmpdir, dict(lr=1e-3, warmup_steps=2, total_steps=24))
    bus = side.MemoryBus()
    agent = side.build_training_agent(env, total_steps=8,
                                      steps_per_intention=4, ckpt_every=100,
                                      bus=bus)
    env.crash_after_steps = 6  # process dies inside the 2nd train_chunk
    agent.send_mail("train")
    with pytest.raises(side.InjectedCrash):
        agent.run_until_idle(max_rounds=10000)
    pend = side.committed_unexecuted(bus)
    assert len(pend) == 1 and pend[0]["kind"] == "train_chunk"
    assert env.step == 6
    env.crash_after_steps = None
    agent.executor = side.Executor(
        side.BusClient(bus, "executor-2", "executor"), env=env,
        handlers=side.handlers, announce_reboot=True)
    agent.run_until_idle(max_rounds=10000)
    assert env.step == 8
    ts = side.trace_intents(bus.read(0))
    probes = [t for t in ts if t.kind == "probe_state"]
    assert probes and probes[0].decision == "commit"
    starts = [t.args["data_start"] for t in ts if t.kind == "train_chunk"
              and t.result and t.result["ok"]]
    assert starts == sorted(starts) and len(set(starts)) == len(starts)
    return _record(side, bus, env)


def test_crash_drill_matches_reference(tmp_path):
    want = _crash_drill(_Side("jax"), str(tmp_path / "j"))
    got = _crash_drill(_Side("torch"), str(tmp_path / "t"))
    _same(got, want)
    kinds = [t["kind"] for t in got["trace"]]
    assert kinds == ["train_chunk", "train_chunk", "probe_state",
                     "train_chunk", "eval"]


def _governed(side, tmpdir):
    """tests/test_system.py::test_logact_training_end_to_end."""
    env = side.env(tmpdir, dict(lr=3e-3, warmup_steps=2, total_steps=16))
    bus = side.MemoryBus()
    agent = side.build_training_agent(env, total_steps=16,
                                      steps_per_intention=4, ckpt_every=8,
                                      bus=bus)
    agent.add_voter(side.RuleVoter(side.BusClient(bus, "rv", "voter"),
                                   rules=side.STANDARD_RULES),
                    from_tail=False)
    agent.set_policy("decider", {"mode": "first_voter"})
    agent.set_policy("voter:rule", {"lr_bounds": (0.0, 0.1)})
    agent.send_mail("train to 16 steps")
    agent.run_until_idle(max_rounds=100000)
    assert env.step == 16
    assert env.ckpts.latest() is not None and env.ckpts.verify(
        env.ckpts.latest())
    s = side.summarize_bus(bus)
    assert s["n_aborted"] == 0
    assert s["n_committed"] == s["n_completed"] >= 5
    for t in side.trace_intents(bus.read(0)):
        if t.kind == "train_chunk":
            assert t.votes and t.decision == "commit" and t.result["ok"]
            assert all(np.isfinite(t.result["value"]["losses"]))
    return _record(side, bus, env)


def test_governed_training_matches_reference(tmp_path):
    want = _governed(_Side("jax"), str(tmp_path / "j"))
    got = _governed(_Side("torch"), str(tmp_path / "t"))
    _same(got, want)
    kinds = [t["kind"] for t in got["trace"]]
    assert kinds == ["train_chunk", "train_chunk", "save_checkpoint",
                     "train_chunk", "train_chunk", "eval"]


def _torch_env(tmpdir):
    return _Side("torch").env(tmpdir, dict(lr=1e-3, warmup_steps=2,
                                           total_steps=24))


def test_checkpoint_roundtrip_and_integrity(tmp_path):
    env = _torch_env(str(tmp_path / "ck"))
    path = env.ckpts.save(3, env.state, log_position=17, data_cursor=5)
    assert env.ckpts.latest() == 3
    assert env.ckpts.verify(3)
    restored, man = env.ckpts.restore(3, env.state)
    assert man["log_position"] == 17 and man["data_cursor"] == 5
    for (a, b) in zip(_leaves(restored), _leaves(env.state)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # corrupt it -> verify fails, restore refuses
    p = os.path.join(path, "state.npz")
    with open(p, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02corrupt")
    assert not env.ckpts.verify(3)
    with pytest.raises(AssertionError):
        env.ckpts.restore(3, env.state)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_checkpoint_delete_guard(tmp_path):
    env = _torch_env(str(tmp_path / "ck2"))
    env.ckpts.save(1, env.state, log_position=0, data_cursor=0)
    with pytest.raises(PermissionError):
        env.ckpts.delete(1, pinned=True)
    env.ckpts.delete(1)
    assert env.ckpts.latest() is None


def test_env_initializes_from_a_seed(tmp_path):
    """Without a given state the env draws its parameters from
    ``init_params`` at the seed: the same seed, the same parameters."""
    cfg = smoke(get_config("qwen3_4b"))
    envs = [build_env(cfg, OptimizerConfig(name="adafactor"),
                      StepConfig(remat="none"),
                      DataConfig(cfg.vocab, 16, 4), str(tmp_path / str(i)),
                      device="cpu") for i in range(2)]
    for env in envs:
        env.ensure_initialized(seed=7)
    for a, b in zip(_leaves(envs[0].state), _leaves(envs[1].state)):
        assert torch.equal(a, b)
    assert set(envs[0].state) == {"params", "opt"}
