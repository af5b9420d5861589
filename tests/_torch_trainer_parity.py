"""Shared parts of the governed trainer's parity tests, on the CPU: each
package's names for the scenarios (``Side``), the smoke env (``qwen3_4b``
by default, or another arch) that both sides start from the reference's
initial parameters, and the record of a run (each intent's kind, args,
decision and result, ``env.step``, the data cursor) compared with losses
to ``LOSS_RTOL`` (rtol = 1e-4, as the trajectories of
``test_torch_train.py``) and everything else exactly (arrays with
``equal_nan=False``).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke as jax_smoke
from repro.core import acl as jax_acl
from repro.core import bus as jax_bus
from repro.core import executor as jax_executor
from repro.core import failover as jax_failover
from repro.core import introspect as jax_introspect
from repro.core import recovery as jax_recovery
from repro.core import voter as jax_voter
from repro.data import pipeline as jax_pipeline
from repro.models.model import Model as JaxModel
from repro.models.params import split_params
from repro.optim import optimizer as jax_optimizer
from repro.train import train_step as jax_train_step
from repro.train import trainer as jax_trainer
from repro_torch.configs.base import get_config, smoke
from repro_torch.core import (STANDARD_RULES, Executor, MemoryBus, RuleVoter,
                              SqliteBus, StandbyExecutor,
                              committed_unexecuted, summarize_bus,
                              trace_intents)
from repro_torch.core.acl import BusClient
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.params import params_from_numpy
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.train_step import StepConfig
from repro_torch.train.trainer import (TRAIN_HANDLERS, InjectedCrash,
                                       build_env, build_training_agent)

LOSS_RTOL = 1e-4


class Side:
    """One package's names for the scenarios."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.MemoryBus = jax_bus.MemoryBus if jax_side else MemoryBus
        self.SqliteBus = jax_bus.SqliteBus if jax_side else SqliteBus
        self.BusClient = jax_acl.BusClient if jax_side else BusClient
        self.Executor = jax_executor.Executor if jax_side else Executor
        self.StandbyExecutor = (jax_failover.StandbyExecutor if jax_side
                                else StandbyExecutor)
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

    def env(self, tmpdir, opt_kw, remat="none", arch="qwen3_4b"):
        """Smoke ``arch``; both sides start from the reference's
        initializer at seed 0."""
        if self.name == "jax":
            cfg = jax_smoke(jax_get_config(arch))
            env = jax_trainer.build_env(
                cfg, jax_optimizer.OptimizerConfig(**opt_kw),
                jax_train_step.StepConfig(remat=remat),
                jax_pipeline.DataConfig(cfg.vocab, 16, 4), tmpdir)
            env.ensure_initialized()
            return env
        cfg = smoke(get_config(arch))
        env = build_env(cfg, OptimizerConfig(**opt_kw),
                        StepConfig(remat=remat),
                        DataConfig(cfg.vocab, 16, 4), tmpdir, device="cpu")
        env.state = env.init_state(params_from_numpy(jax_init(arch), "cpu"))
        return env


def jax_init(arch="qwen3_4b"):
    m = JaxModel(jax_smoke(jax_get_config(arch)), dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        split_params(m.init(jax.random.PRNGKey(0)))[0])


def record(side, bus, env):
    """What the run did: each intent's kind, args, decision and result."""
    trace = []
    for t in side.trace_intents(bus.read(0)):
        res = t.result or {}
        trace.append({"kind": t.kind, "args": t.args,
                      "decision": t.decision, "ok": res.get("ok"),
                      "value": {k: v for k, v in (res.get("value") or {})
                                .items() if k != "path"}})
    return {"trace": trace, "step": env.step, "cursor": env.data_cursor}


def same(a, b, path=""):
    """Equal, with floats (losses and what derives from them) to
    LOSS_RTOL."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a), set(b))
        for k in a:
            same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=0,
                                   equal_nan=False, err_msg=path)
    else:
        assert a == b, (path, a, b)
