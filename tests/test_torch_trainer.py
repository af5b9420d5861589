"""The port's governed trainer against the reference's, on the CPU, over
smoke ``qwen3_4b`` with the same initial parameters on both sides: the
executor-crash drill of ``tests/test_recovery.py`` (crash inside the
second chunk, a rebooted executor, probe and roll forward) and the
governed end to end of ``tests/test_system.py`` (``STANDARD_RULES``, a
log-anchored checkpoint, a final eval). Each run's intents (kinds, args,
decisions), ``env.step``, data cursors and losses are held to the
reference run's. Then the checkpoint integrity and delete-guard tests of
``tests/test_recovery.py``, on a torch env.

Tolerance (``_torch_trainer_parity``): losses (and the
``expected_loss`` the planner derives from them) rtol = 1e-4, as the
trajectories of ``test_torch_train.py``; everything else is exact.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_trainer_parity as parity  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import StepConfig  # noqa: E402
from repro_torch.train.trainer import build_env  # noqa: E402

torch.set_num_threads(1)


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
    return parity.record(side, bus, env)


def test_crash_drill_matches_reference(tmp_path):
    want = _crash_drill(parity.Side("jax"), str(tmp_path / "j"))
    got = _crash_drill(parity.Side("torch"), str(tmp_path / "t"))
    parity.same(got, want)
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
    return parity.record(side, bus, env)


def test_governed_training_matches_reference(tmp_path):
    want = _governed(parity.Side("jax"), str(tmp_path / "j"))
    got = _governed(parity.Side("torch"), str(tmp_path / "t"))
    parity.same(got, want)
    kinds = [t["kind"] for t in got["trace"]]
    assert kinds == ["train_chunk", "train_chunk", "save_checkpoint",
                     "train_chunk", "train_chunk", "eval"]


def _torch_env(tmpdir):
    return parity.Side("torch").env(tmpdir, dict(lr=1e-3, warmup_steps=2,
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
