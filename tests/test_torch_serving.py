"""The port's continuous-batching engine and governed serving agent against
the reference's, on the smoke ``qwen3_4b`` with the reference's parameters
carried over (``params_from_numpy``), on the CPU.

Tokens are greedy argmaxes and must be equal exactly: both sides compute
in fp32, and the few-ulp differences of another summation order do not
move an argmax at these widths. The KV arenas are compared at 1e-5
(atol/rtol) for the same reason as the layer tests.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke as jax_smoke  # noqa: E402
from repro.core.acl import BusClient as JaxBusClient  # noqa: E402
from repro.core.voter import RuleVoter as JaxRuleVoter  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.serving import server as jax_server  # noqa: E402
from repro.serving.engine import PagedEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.core.acl import BusClient  # noqa: E402
from repro_torch.core.voter import RuleVoter  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import server  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke(jax_get_config("qwen3_4b"))
    tcfg = smoke(get_config("qwen3_4b"))
    jparams, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(setup, **kw):
    jcfg, tcfg, jparams, tparams = setup
    return (JaxEngine(jcfg, params=jparams, **kw),
            PagedEngine(tcfg, params=tparams, device="cpu", **kw))


# ---------------------------------------------------------------------------
# engine: the reference's scenarios, port vs reference
# ---------------------------------------------------------------------------

def test_engine_closed_loop_parity(setup):
    prompt = [5, 17, 99, 3, 42]
    outs = []
    for eng in _engines(setup, max_batch=4, num_pages=32, page_size=8):
        assert eng.admit("r", prompt, 6)
        done = []
        for _ in range(8):
            done += eng.step()
            if not eng.n_inflight:
                break
        outs.append(done[0].tokens)
        eng.pool.check_invariants()
        assert eng.pool.n_pages_in_use == 0   # retirement freed everything
    assert outs[0] == outs[1]


def test_engine_staggered_admission_parity(setup):
    """Sequences admitted mid-decode: the same tokens and, mid-run, the
    same K/V written into the same pool slots."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 100, size=n).tolist() for n in (5, 9, 13, 2)]
    engines = _engines(setup, max_batch=3, num_pages=32, page_size=8)
    results = []
    for eng in engines:
        queue = list(enumerate(prompts))
        done, snap = {}, None
        while queue or eng.n_inflight:
            if queue and eng.can_admit(len(queue[0][1]), 6):
                i, p = queue.pop(0)
                assert eng.admit(f"r{i}", p, 6)
            for s in eng.step():
                done[s.req_id] = s.tokens
            if eng.n_steps == 3 and snap is None:
                snap = [np.array(eng.pool.k), np.array(eng.pool.v)]
            assert eng.n_steps < 60
        results += [snap, done]
        eng.pool.check_invariants()
    (jk, jv), jdone, (tk, tv), tdone = results
    assert jdone == tdone and len(jdone) == 4
    np.testing.assert_allclose(tk, jk, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)


def test_engine_capacity_backpressure_parity(setup):
    outs = []
    for eng in _engines(setup, max_batch=2, num_pages=8, page_size=8):
        log = [eng.admit("a", [1, 2, 3], 4), eng.admit("b", [4, 5], 4),
               eng.admit("c", [6], 4),       # no free lane
               eng.admit("a", [9], 4)]       # duplicate id
        done = {}
        while eng.n_inflight:
            done.update((s.req_id, s.tokens) for s in eng.step())
        log.append(eng.admit("c", [6], 4))  # lane + pages recycled
        while eng.n_inflight:
            done.update((s.req_id, s.tokens) for s in eng.step())
        outs.append((log, done, eng.n_steps))
    assert outs[0] == outs[1]
    assert outs[1][0] == [True, True, False, False, True]


# ---------------------------------------------------------------------------
# governed serving: port agent vs reference agent
# ---------------------------------------------------------------------------

def _governed(setup, policy, mails, spawn=None):
    """Run the reference's and the port's governed agents side by side;
    returns (planner, entry-type list) per side. ``spawn(side, kw)``,
    where given, builds each side's agent (through an ``AgentKernel``,
    say) in place of ``build_continuous_serving_agent(cfg, **kw)``; the
    engine on the carried-over parameters is set on it all the same."""
    jcfg, tcfg, jparams, tparams = setup
    out = []
    for side in ("jax", "torch"):
        srv, vote_cls, client_cls = (
            (jax_server, JaxRuleVoter, JaxBusClient) if side == "jax"
            else (server, RuleVoter, BusClient))
        kw = dict(max_batch=4, num_pages=64, page_size=8, max_new_tokens=4)
        if spawn is not None:
            agent = spawn(side, kw)
        elif side == "jax":
            agent = srv.build_continuous_serving_agent(jcfg, **kw)
        else:
            agent = srv.build_continuous_serving_agent(tcfg, device="cpu",
                                                       **kw)
        if side == "jax":
            agent.executor.env.engine = JaxEngine(jcfg, params=jparams,
                                                  max_batch=4, num_pages=64,
                                                  page_size=8)
        else:
            agent.executor.env.engine = PagedEngine(
                tcfg, params=tparams, max_batch=4, num_pages=64,
                page_size=8, device="cpu")
        voter = vote_cls(client_cls(agent.bus, "v-rule", "voter"),
                         rules=srv.SERVE_ADMISSION_RULES)
        agent.add_voter(voter, from_tail=False)
        agent.set_policy("decider", {"mode": "first_voter"})
        if policy:
            agent.set_policy("voter:rule", policy)
        for text, kwargs in mails:
            agent.send_mail(text, **kwargs)
        agent.run_until_idle()
        types = [e.type.name for e in
                 agent.external_client("t", "admin").read(0)]
        out.append((agent.driver.planner, types))
    return out


def test_governed_end_to_end_parity(setup):
    mails = [(f"req {i}", dict(prompt_tokens=p, req_id=f"r{i}"))
             for i, p in enumerate([[7, 8, 9], [11, 12], [13, 14, 15, 16]])]
    (jpl, jtypes), (tpl, ttypes) = _governed(setup, None, mails)
    assert set(tpl.outputs) == {"r0", "r1", "r2"}
    assert tpl.outputs == jpl.outputs
    assert tpl.rejected == jpl.rejected == []
    assert ttypes == jtypes


@pytest.mark.parametrize("policy,mails,rejected", [
    ({"tenant_denylist": ["evil"]},
     [("ok", dict(prompt_tokens=[1, 2], req_id="good")),
      ("no", dict(prompt_tokens=[3, 4], req_id="bad", tenant="evil"))],
     ["bad"]),
    ({"max_tokens_per_request": 6},
     [("small", dict(prompt_tokens=[1], req_id="small")),    # 1+4 <= 6
      ("big", dict(prompt_tokens=[1, 2, 3], req_id="big"))],  # 3+4 > 6
     ["big"]),
], ids=["tenant_denylist", "prompt_budget"])
def test_governed_admission_control_parity(setup, policy, mails, rejected):
    (jpl, jtypes), (tpl, ttypes) = _governed(setup, policy, mails)
    assert tpl.outputs == jpl.outputs and len(tpl.outputs) == 1
    assert tpl.rejected == jpl.rejected == rejected
    # the veto shows on the log as Abort entries, not as silence
    assert "ABORT" in ttypes
    assert ttypes == jtypes


def _intent_bodies():
    def step(admit, n_inflight=0):
        return {"kind": "serve_step",
                "args": {"step": 1, "admit": admit, "n_inflight": n_inflight}}
    r = [{"req_id": f"r{i}", "tenant": t, "prompt_tokens": [1] * n,
          "max_new_tokens": m}
         for i, (t, n, m) in enumerate([("default", 3, 4), ("evil", 2, 4),
                                        ("default", 9, 8)])]
    return [step([]), step(r[:1]), step(r[:2]), step(r, n_inflight=2),
            step(r[2:], n_inflight=5), {"kind": "serve_batch", "args": {}}]


@pytest.mark.parametrize("pol", [
    {}, {"tenant_denylist": ["evil"]}, {"max_admit_per_step": 1},
    {"max_inflight": 4}, {"max_tokens_per_request": 10},
    {"tenant_denylist": ["x"], "max_admit_per_step": 2, "max_inflight": 6,
     "max_tokens_per_request": 16}])
def test_admission_rules_decide_identically(pol):
    for body in _intent_bodies():
        for jrule, trule in zip(jax_server.SERVE_ADMISSION_RULES,
                                server.SERVE_ADMISSION_RULES):
            assert jrule.__name__ == trule.__name__
            j, t = jrule(body, pol), trule(body, pol)
            assert (j is None) == (t is None), (jrule.__name__, body, pol)
            if j is not None:
                assert (j.approve, j.reason) == (t.approve, t.reason)


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(get_config("qwen3_4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.build_continuous_serving_agent(cfg)
    assert PagedEngine(cfg, device="cpu").device.type == "cpu"
