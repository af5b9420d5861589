"""The port's static serving discipline (``ServeEnv`` / ``h_serve_batch`` /
``ServePlanner`` / ``build_serving_agent``) against the reference's, on
the smoke ``mamba2_780m`` with the reference's parameters carried over
(``params_from_numpy``), on the CPU.

Tokens are greedy argmaxes and must be equal exactly: both sides compute
in fp32, and the few-ulp differences of another summation order do not
move an argmax at these widths. The reference's quirks are part of the
contract and are checked as such: left-padding with token 0, dummy
``pad_batch`` rows dropped from the result, the argmax over the padded
vocab, the first decoded position at the prompt length.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke as jax_smoke  # noqa: E402
from repro.core.acl import BusClient as JaxBusClient  # noqa: E402
from repro.core.entries import PayloadType as JaxPayloadType  # noqa: E402
from repro.core.voter import RuleVoter as JaxRuleVoter  # noqa: E402
from repro.core.voter import STANDARD_RULES as JAX_RULES  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.serving import server as jax_server  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.core.acl import BusClient  # noqa: E402
from repro_torch.core.entries import PayloadType  # noqa: E402
from repro_torch.core.voter import STANDARD_RULES, RuleVoter  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_numpy)
from repro_torch.serving import server  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke(jax_get_config("mamba2_780m"))
    tcfg = smoke(get_config("mamba2_780m"))
    jparams, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jenv = jax_server.ServeEnv(model=JaxModel(jcfg, dtype=jnp.float32),
                               params=jparams)
    tenv = server.ServeEnv(model=Model(tcfg), params=tparams, device="cpu")
    return jcfg, tcfg, jparams, tparams, jenv, tenv


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("lens,extra", [
    ((5, 9, 2), {}),                                   # ragged: left pad
    ((7, 3), {"pad_batch": 4}),                        # dummy rows dropped
    ((37,), {"max_new_tokens": 5}),                    # three 16-token chunks
    ((4, 4, 4), {"pad_batch": 2, "req_ids": ["a", "b", "c"]}),
], ids=["ragged", "pad_batch", "multi_chunk", "req_ids"])
def test_h_serve_batch_matches_reference(setup, lens, extra):
    jcfg, tcfg, _, _, jenv, tenv = setup
    args = {"prompts": _prompts(len(lens), lens, tcfg.vocab),
            "max_new_tokens": 4, **extra}
    want = jax_server.h_serve_batch(dict(args), jenv)
    got = server.h_serve_batch(dict(args), tenv)
    assert got == want
    assert got["batch"] == len(lens) == len(got["generated"])
    assert got["prefill_len"] == max(lens)
    assert all(len(r) == args["max_new_tokens"] for r in got["generated"])


def test_left_pad_with_token_zero_is_part_of_the_contract(setup):
    """An SSM does not mask the pad: a short prompt served beside a long
    one is continued from the zero-padded sequence, on both sides."""
    _, tcfg, _, tparams, jenv, tenv = setup
    short, long_ = _prompts(21, (3, 11), tcfg.vocab)
    args = {"prompts": [short, long_], "max_new_tokens": 3}
    got = server.h_serve_batch(dict(args), tenv)
    assert got == jax_server.h_serve_batch(dict(args), jenv)
    padded = server.h_serve_batch(
        {"prompts": [[0] * 8 + short], "max_new_tokens": 3}, tenv)
    assert got["generated"][0] == padded["generated"][0]


def _governed(setup, policy, mails, **agent_kw):
    """Run the reference's and the port's governed static agents side by
    side with a RuleVoter on STANDARD_RULES; returns, per side, the Result
    values, the Result ok flags and the log's entry types."""
    jcfg, tcfg, jparams, tparams, _, _ = setup
    out = []
    for side in ("jax", "torch"):
        if side == "jax":
            agent = jax_server.build_serving_agent(jcfg, **agent_kw)
            agent.executor.env.params = jparams
            voter = JaxRuleVoter(JaxBusClient(agent.bus, "v-rule", "voter"),
                                 rules=JAX_RULES)
            result_type = JaxPayloadType.RESULT
        else:
            agent = server.build_serving_agent(tcfg, device="cpu",
                                               **agent_kw)
            agent.executor.env.params = tparams
            voter = RuleVoter(BusClient(agent.bus, "v-rule", "voter"),
                              rules=STANDARD_RULES)
            result_type = PayloadType.RESULT
        agent.add_voter(voter, from_tail=False)
        agent.set_policy("decider", {"mode": "first_voter"})
        if policy:
            agent.set_policy("voter:rule", policy)
        for text, kwargs in mails:
            agent.send_mail(text, **kwargs)
        agent.run_until_idle()
        log = agent.external_client("t", "admin").read(0)
        results = [e.body for e in log if e.type == result_type]
        out.append(([r.get("value") for r in results],
                    [r.get("ok") for r in results],
                    [e.type.name for e in log]))
    return out


def _mails(setup, lens):
    tcfg = setup[1]
    return [(f"req {i}", dict(prompt_tokens=p, req_id=f"r{i}"))
            for i, p in enumerate(_prompts(31, lens, tcfg.vocab))]


def test_governed_static_serving_matches_reference(setup):
    mails = _mails(setup, (6, 3, 9, 4, 5))
    (jvals, jok, jtypes), (tvals, tok, ttypes) = _governed(
        setup, None, mails, max_batch=2, pad_batch=2)
    assert tok == jok == [True, True, True]
    assert [v["batch"] for v in tvals] == [2, 2, 1]
    assert [v["req_ids"] for v in tvals] == [["r0", "r1"], ["r2", "r3"],
                                             ["r4"]]
    assert tvals == jvals  # the same generated rows, batch for batch
    assert ttypes == jtypes
    assert "ABORT" not in ttypes


def test_denylisted_serve_batch_is_aborted_on_both_sides(setup):
    mails = _mails(setup, (6, 3, 9))
    before = ssd_intra.launches
    (jvals, _, jtypes), (tvals, _, ttypes) = _governed(
        setup, {"kind_denylist": ["serve_batch"]}, mails, max_batch=2)
    assert tvals == jvals == []  # nothing executed
    assert ttypes == jtypes
    assert ttypes.count("ABORT") == 2 and "COMMIT" not in ttypes
    assert ssd_intra.launches == before


def test_serve_handlers_match_reference():
    assert set(server.SERVE_HANDLERS) == set(jax_server.SERVE_HANDLERS) \
        == {"serve_batch", "serve_step"}
    agent = server.build_serving_agent(smoke(get_config("mamba2_780m")),
                                       device="cpu")
    assert set(agent.executor.handlers) >= {"serve_batch", "serve_step"}


def test_serve_env_draws_params_from_a_seeded_generator():
    cfg = smoke(get_config("mamba2_780m"))
    env = server.ServeEnv(model=Model(cfg), device="cpu")
    env.ensure_initialized(seed=3)
    want = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(env.params["layers"]["mamba"]["w_in"],
                       want["layers"]["mamba"]["w_in"])
    assert torch.equal(env.params["embed"], want["embed"])


def test_static_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(get_config("mamba2_780m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        server.build_serving_agent(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.ServeEnv(model=Model(cfg)).ensure_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init_cache(1, 4)
    agent = server.build_serving_agent(cfg, device="cpu")
    assert agent.executor.env.device.type == "cpu"


def test_static_serving_of_an_unported_family_raises():
    # every family of the reference is served (tests/test_torch_hybrid.py,
    # tests/test_torch_encdec_vlm.py and others); an unknown one raises
    # ValueError naming it, from init_params as from the reference's
    cfg = dataclasses.replace(smoke(get_config("qwen3_4b")),
                              family="bogus")
    env = server.ServeEnv(model=Model(cfg), device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        server.h_serve_batch({"prompts": [[1, 2]], "max_new_tokens": 2}, env)
