"""The port's launchers (``repro_torch.launch.serve`` / ``.train``) against
the reference's (``repro.launch.serve`` / ``.train``), on the CPU at the
smoke configs (vocab 256): the reference's ``main()`` through
``sys.argv``, the port's ``main([..., "--device", "cpu"])``. Both sides
start from one numpy tree, the reference's initial parameters: each
launcher module's ``build_serving_agent`` / ``build_env`` is wrapped so
that the agent or env it returns holds them (``params_from_numpy`` on the
port's side).

Held: every printed line of the serving launcher (batches, new tokens,
decisions, served count, log entries and KB) and the tokens generated,
read from each log; of the training launcher the steps, checkpoint
steps, log entries, commits and aborts exactly and the first and last
loss, and every step's loss between, to ``LOSS_RTOL`` (rtol 1e-4, the
trainer tests'); at 16 steps the step-8 checkpoint on both sides, its
npz keys, shapes and dtypes equal. Also the
``--full-config`` data vocabulary (``DataConfig`` only: the full model is
not built here) and the refusal to run without CUDA unless
``--device cpu`` is given.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
import _torch_trainer_parity as tparity
from repro.core.introspect import trace_intents as jax_trace_intents
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro_torch.configs.base import get_config
from repro_torch.core import trace_intents
from repro_torch.launch import serve, train
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)


def _setup(arch):
    """(jcfg, tcfg, the reference's initial parameters as numpy) of the
    launchers' smoke config."""
    jcfg, tcfg, jparams, _ = parity.setup(arch, vocab=256)
    return jcfg, tcfg, jparams


def _wrap(monkeypatch, module, name, built, cfg=None, finish=None):
    """``module.name`` (a function that builds an agent or env) wrapped:
    the config it gets must be ``cfg`` (where given); ``finish`` (where
    given) sets the parameters on what it built; what it built is
    appended to ``built``."""
    build = getattr(module, name)

    def wrapped(c, *args, **kw):
        assert cfg is None or c == cfg
        out = build(c, *args, **kw)
        if finish is not None:
            finish(out)
        built.append(out)
        return out
    monkeypatch.setattr(module, name, wrapped)


def _reference_main(monkeypatch, capsys, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.splitlines()


def _port_main(capsys, module, argv):
    capsys.readouterr()
    agent = module.main(argv + ["--device", "cpu"])
    return agent, capsys.readouterr().out.splitlines()


def _generated(trace, bus):
    return [t.result["value"]["generated"] for t in trace(bus.read(0))
            if t.kind == "serve_batch" and t.result and t.result["ok"]]


@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_780m"])
def test_serve_prints_what_the_reference_prints(arch, monkeypatch, capsys):
    jcfg, tcfg, jparams = _setup(arch)
    tparams = params_from_numpy(jparams, "cpu")
    built = []

    def jax_finish(agent):
        agent.executor.env.params = jparams

    def port_finish(agent):
        agent.executor.env.params = tparams
    _wrap(monkeypatch, jax_serve, "build_serving_agent", built, jcfg,
          jax_finish)
    _wrap(monkeypatch, serve, "build_serving_agent", built, tcfg,
          port_finish)
    argv = ["--arch", arch, "-n", "4"]
    want = _reference_main(monkeypatch, capsys, jax_serve, argv)
    agent, got = _port_main(capsys, serve, argv)
    assert len(built) == 2 and built[1] is agent
    assert got == want
    assert want[-1].startswith("served 4/4 requests; log ")
    tokens = _generated(trace_intents, agent.bus)
    assert tokens == _generated(jax_trace_intents, built[0].bus)
    assert sum(map(len, tokens)) == 4


def _train_run(monkeypatch, capsys, tmp_path, argv):
    """Both launchers on ``argv`` from the same initial parameters; returns
    the reference's and the port's (printed lines, agent)."""
    jcfg, tcfg, jparams = _setup("qwen3_4b")
    envs, agents = [], []

    def jax_finish(env):
        env.state = env.init_state(jax.tree.map(jnp.asarray, jparams))

    def port_finish(env):
        env.state = env.init_state(params_from_numpy(jparams, "cpu"))
    _wrap(monkeypatch, jax_train, "build_env", envs, jcfg, jax_finish)
    _wrap(monkeypatch, train, "build_env", envs, tcfg, port_finish)
    _wrap(monkeypatch, jax_train, "build_training_agent", agents)
    want = _reference_main(monkeypatch, capsys, jax_train, argv + [
        "--workdir", str(tmp_path / "jax")])
    agent, got = _port_main(capsys, train, argv + [
        "--workdir", str(tmp_path / "torch")])
    assert len(envs) == 2 and envs[1] is agent.executor.env
    assert agents[0].executor.env is envs[0]
    return (want, agents[0]), (got, agent)


def _losses(trace, bus):
    """Every step's loss, from the ``train_chunk`` Results on the log (the
    launcher prints the first and last chunk's last loss)."""
    return [x for t in trace(bus.read(0))
            if t.kind == "train_chunk" and t.result and t.result["ok"]
            for x in t.result["value"]["losses"]]


LINE = re.compile(r"arch=(\S+) steps=(\S+) ckpts=(\[.*\]) workdir=\S+")
LOG = re.compile(r"loss first=\S+ last=\S+; log (\d+) entries / \S+ KB "
                 r"\((\d+) commits, (\d+) aborts\)")


@pytest.mark.parametrize("argv", [["--bus", "memory"], ["--bus", "sqlite"],
                                  ["--bus", "memory", "--dual-voter"]],
                         ids=["memory", "sqlite", "dual_voter"])
def test_train_prints_what_the_reference_prints(argv, monkeypatch, capsys,
                                                tmp_path):
    """8 steps are one ``train_chunk`` of 8 and the final eval: the
    planner evaluates once the target is reached, before any periodic
    checkpoint, so both sides list none."""
    (want, jagent), (got, agent) = _train_run(
        monkeypatch, capsys, tmp_path, ["--steps", "8"] + argv)
    assert len(got) == len(want) == 2
    assert LINE.fullmatch(got[0]).groups() == LINE.fullmatch(
        want[0]).groups() == ("qwen3_4b", "8/8", "[]")
    assert LOG.fullmatch(got[1]).groups() == LOG.fullmatch(want[1]).groups()
    env, jenv = agent.executor.env, jagent.executor.env
    assert (env.step, env.data_cursor, env.ckpts.list_steps()) == (
        jenv.step, jenv.data_cursor, jenv.ckpts.list_steps())
    losses = _losses(trace_intents, agent.bus)
    assert len(losses) == 8
    np.testing.assert_allclose(losses, _losses(jax_trace_intents,
                                               jagent.bus),
                               rtol=tparity.LOSS_RTOL, atol=0)
    kinds = [t.kind for t in trace_intents(agent.bus.read(0))]
    assert kinds == [t.kind for t in jax_trace_intents(jagent.bus.read(0))]
    assert kinds == ["train_chunk", "eval"]
    if "sqlite" in argv:
        assert (tmp_path / "torch" / "bus.db").exists()


def test_train_checkpoints_on_the_way_to_16_steps(monkeypatch, capsys,
                                                  tmp_path):
    """16 steps: ``ckpt_every = max(16 // 3, 8)`` is 8, so both launchers
    save the step-8 checkpoint between their two chunks of 8, then
    evaluate; the port's npz holds the reference's keys at the same
    shapes and dtypes."""
    (want, jagent), (got, agent) = _train_run(
        monkeypatch, capsys, tmp_path, ["--steps", "16", "--bus", "sqlite"])
    assert LINE.fullmatch(got[0]).groups() == LINE.fullmatch(
        want[0]).groups() == ("qwen3_4b", "16/16", "[8]")
    assert LOG.fullmatch(got[1]).groups() == LOG.fullmatch(want[1]).groups()
    kinds = [t.kind for t in trace_intents(agent.bus.read(0))]
    assert kinds == [t.kind for t in jax_trace_intents(jagent.bus.read(0))]
    assert kinds == ["train_chunk", "save_checkpoint", "train_chunk", "eval"]
    losses = _losses(trace_intents, agent.bus)
    assert len(losses) == 16
    np.testing.assert_allclose(losses, _losses(jax_trace_intents,
                                               jagent.bus),
                               rtol=tparity.LOSS_RTOL, atol=0)
    npz = [tmp_path / side / "ckpts" / "step-0000000008" / "state.npz"
           for side in ("jax", "torch")]
    with np.load(npz[0]) as jz, np.load(npz[1]) as tz:
        assert sorted(tz.files) == sorted(jz.files)
        assert {k: (tz[k].shape, tz[k].dtype) for k in tz.files} == {
            k: (jz[k].shape, jz[k].dtype) for k in jz.files}


def test_full_config_cuts_only_the_data_vocabulary(monkeypatch, capsys):
    """``--full-config``: ``main`` builds ``DataConfig`` with the vocab cut
    to 4096 and prints so; ``build_env`` (stopped here) gets the full
    config. The smoke config's 256 is not cut."""
    seen = {}

    class Stop(Exception):
        pass

    def stop(cfg, opt, step, data, root, device=None):
        seen.update(cfg=cfg, step=step, data=data)
        raise Stop
    monkeypatch.setattr(train, "build_env", stop)
    capsys.readouterr()
    with pytest.raises(Stop):
        train.main(["--full-config", "--device", "cpu"])
    full = get_config("qwen3_4b")
    assert seen["cfg"] == full and seen["step"].remat == "dots"
    assert (seen["data"].vocab, seen["data"].seq_len,
            seen["data"].global_batch) == (4096, 64, 8)
    assert capsys.readouterr().out == (
        f"data vocab cut to 4096 from {full.vocab} (the pipeline's dense "
        f"vocab x vocab table); the model and its loss keep "
        f"{full.vocab}\n")
    with pytest.raises(Stop):
        train.main(["--device", "cpu"])
    assert seen["data"].vocab == 256 and seen["step"].remat == "none"
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("module", [serve, train],
                         ids=["serve", "train"])
def test_without_cuda_the_launchers_raise(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
