"""The port's moe family against the reference's, on the CPU:
``models/moe.py`` (``capacity``, the top-k routing with its tie order,
the capacity dispatch and its drop rule, the aux losses, the shared
expert), the moe parameter tree, and smoke ``mixtral_8x7b`` (top-2 of 4
experts, window 32) and ``kimi_k2_1t_a32b`` (a shared expert) through
prefill, decode (mixtral's ring-buffer cache wrapping), ``loss_fn`` with
its aux terms and gradients, and the governed static agent.

The reference's own dispatch is read off its run: its module's ``jnp``
and ``jax`` are wrapped to record what ``argsort``, ``where`` and
``lax.top_k`` return, so the port's order, ranks and keep mask are held
to the reference's, not to a second copy of its rule.

Tolerances: the routing, the dispatch order, the ranks and the keep mask
equal exactly; ``moe_block``'s output and aux losses rtol 1e-6 with atol
1e-6 x the largest magnitude (fp32 on both sides, sums in another
order); the model-level checks as ``_torch_model_parity`` states them
(logits and K/V 2e-4, the loss 1e-5, gradients rtol 1e-4 with atol 4e-5
x the leaf's largest magnitude, tokens equal).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_model_parity as parity  # noqa: E402
from repro.core.acl import BusClient as JaxBusClient  # noqa: E402
from repro.core.voter import RuleVoter as JaxRuleVoter  # noqa: E402
from repro.core.voter import STANDARD_RULES as JAX_RULES  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.serving import server as jax_server  # noqa: E402
from repro_torch.core.acl import BusClient  # noqa: E402
from repro_torch.core.voter import STANDARD_RULES, RuleVoter  # noqa: E402
from repro_torch.kernels.flash_attention import flash_mha  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_numpy, params_to_numpy)
from repro_torch.serving import server  # noqa: E402

torch.set_num_threads(1)
MOE_TOL = 1e-6
CASES = {"mixtral": "mixtral_8x7b", "kimi": "kimi_k2_1t_a32b"}
_SETUPS = {}


def _setup(case):
    if case not in _SETUPS:
        _SETUPS[case] = parity.setup(CASES[case])
    return _SETUPS[case]


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    """The reference's grid (``tests/test_misc_units.py:63``) and more."""
    for n in (1, 7, 64, 100, 1000, 9000):
        for e in (1, 4, 8, 384):
            for k in (1, 2, 8):
                for cf in (0.5, 1.0, 1.25, 2.0, 8.0):
                    assert moe.capacity(n, e, k, cf) == \
                        jax_moe.capacity(n, e, k, cf), (n, e, k, cf)
    assert moe.capacity(9000, 8, 2, 1.25) == 2812


class _Recorder:
    """Stands in for a module (``jnp``, ``jax`` or ``jax.lax``) inside the
    reference's ``moe``: every attribute is the module's, and the calls
    named in ``record`` are logged with their arguments and results."""

    def __init__(self, mod, record, log, sub=None):
        self._mod, self._record, self._log = mod, record, log
        self._sub = sub or {}

    def __getattr__(self, name):
        if name in self._sub:
            return self._sub[name]
        fn = getattr(self._mod, name)
        if name not in self._record:
            return fn

        def logged(*args, **kw):
            out = fn(*args, **kw)
            self._log.setdefault(name, []).append((args, out))
            return out
        return logged


def _jax_moe(x, p, cfg, monkeypatch):
    """The reference's moe_block, with its top-k, argsort and the where
    that builds the clamped ranks recorded."""
    log = {}
    lax = _Recorder(jax.lax, {"top_k"}, log)
    monkeypatch.setattr(jax_moe, "jnp", _Recorder(jnp, {"argsort", "where"},
                                                  log))
    monkeypatch.setattr(jax_moe, "jax", _Recorder(jax, (), log,
                                                  sub={"lax": lax}))
    out, aux = jax_moe.moe_block(jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in p.items()},
                                 cfg)
    (_, (_, top_e)), = log["top_k"]
    (_, order), = log["argsort"]
    keep, rank, _ = log["where"][0][0]
    return out, aux, {"top_e": top_e, "order": order, "rank": rank,
                      "keep": keep}


def _moe_inputs(cfg, b, s, seed, router_zero_cols=()):
    """x (b, s, D) and one layer's moe weights, from numpy; the router's
    ``router_zero_cols`` zeroed, so that those experts' logits tie at 0."""
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_ff_expert
    rng = np.random.default_rng(seed)
    f = np.float32
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if m.n_shared_experts:
        fs = F * m.n_shared_experts
        p.update(ws_gate=rng.standard_normal((D, fs)) / np.sqrt(D),
                 ws_up=rng.standard_normal((D, fs)) / np.sqrt(D),
                 ws_down=rng.standard_normal((fs, D)) / np.sqrt(fs))
    p = {k: v.astype(f) for k, v in p.items()}
    p["router"][:, list(router_zero_cols)] = 0.0
    return rng.standard_normal((b, s, D)).astype(f), p


def _port_moe(x, p, cfg):
    """The port's moe_block and its routing and dispatch on the same
    inputs (``route`` and ``dispatch_plan`` are what moe_block runs)."""
    xt = torch.from_numpy(x)
    pt = params_from_numpy(p, "cpu")
    out, aux = moe.moe_block(xt, pt, cfg)
    m = cfg.moe
    n = x.shape[0] * x.shape[1]
    _, probs, _, top_e = moe.route(xt.reshape(n, -1), pt["router"], m.top_k)
    order, _, rank, keep = moe.dispatch_plan(
        top_e, m.n_experts, moe.capacity(n, m.n_experts, m.top_k,
                                         m.capacity_factor))
    return out, aux, {"top_e": top_e, "order": order, "rank": rank,
                      "keep": keep, "probs": probs}


def _close_rel(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=MOE_TOL,
        atol=MOE_TOL * max(float(np.abs(want).max()), 1e-30),
        equal_nan=False)


@pytest.mark.parametrize("case,cf", [("mixtral", 0.5), ("mixtral", 0.75),
                                     ("kimi", 0.5), ("mixtral", 8.0)],
                         ids=["mixtral_cf0.5", "mixtral_cf0.75",
                              "kimi_shared_cf0.5", "mixtral_no_drop"])
def test_moe_block_matches_reference(case, cf, monkeypatch):
    """At a capacity factor below 1 pairs drop: the routing, the stable
    dispatch order, the ranks and the keep mask equal the reference's
    exactly; the output and the aux losses within 1e-6."""
    jcfg, tcfg = parity.configs(CASES[case])
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (jcfg, tcfg))
    x, p = _moe_inputs(tcfg, 2, 24, seed=4)
    jout, jaux, jplan = _jax_moe(x, p, jcfg, monkeypatch)
    out, aux, plan = _port_moe(x, p, tcfg)
    for k in ("top_e", "order", "rank", "keep"):
        np.testing.assert_array_equal(plan[k].numpy(),
                                      np.asarray(jplan[k]), err_msg=k)
    n_dropped = int((~plan["keep"]).sum())
    assert (n_dropped > 0) == (cf < 1)
    _close_rel(out, jout)
    assert aux.keys() == jaux.keys() == {"aux_lb", "aux_z"}
    for k in aux:
        assert aux[k].dtype == torch.float32
        _close_rel(aux[k], jaux[k])


def test_moe_block_drop_rule_is_seen_by_the_output(monkeypatch):
    """Broken control: the reference without drops (capacity factor 8)
    misses the port's output at a factor of 0.5 by more than the limit."""
    jcfg, tcfg = parity.configs("mixtral_8x7b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    x, p = _moe_inputs(tcfg, 2, 24, seed=4)
    jout, _, _ = _jax_moe(x, p, jcfg, monkeypatch)
    out, _, _ = _port_moe(x, p, tcfg)
    with pytest.raises(AssertionError):
        _close_rel(out, jout)


@pytest.mark.parametrize("zero_cols", [(2, 3), (0, 1, 2, 3), (1, 2)],
                         ids=["two_tied", "all_tied", "tie_at_the_cut"])
def test_topk_ties_follow_the_reference(zero_cols, monkeypatch):
    """Experts whose router columns are zero tie at logit 0 for every
    token: the port orders them as ``jax.lax.top_k`` does (descending,
    the lower index first), also where the tie straddles the k-th place,
    and the dispatch and output follow the reference's."""
    jcfg, tcfg = parity.configs("mixtral_8x7b")
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.75)) for c in (jcfg, tcfg))
    x, p = _moe_inputs(tcfg, 2, 24, seed=5, router_zero_cols=zero_cols)
    jout, _, jplan = _jax_moe(x, p, jcfg, monkeypatch)
    out, _, plan = _port_moe(x, p, tcfg)
    probs = plan["probs"]
    tied = probs[:, list(zero_cols)]
    assert torch.all(tied == tied[:, :1])  # exact ties
    # the tie order itself, on the port's own probabilities
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), tcfg.moe.top_k)
    np.testing.assert_array_equal(plan["top_e"].numpy(), np.asarray(want))
    for k in ("top_e", "order", "rank", "keep"):
        np.testing.assert_array_equal(plan[k].numpy(),
                                      np.asarray(jplan[k]), err_msg=k)
    _close_rel(out, jout)


def test_moe_params_tree_matches_reference():
    """``init_params`` builds the reference's moe tree (shapes, keys,
    shared experts), by its scale rule; ``params_to_numpy`` and
    ``params_from_numpy`` carry it across to the bit."""
    for case in CASES:
        jcfg, tcfg = parity.configs(CASES[case])
        jtree, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0)))
        got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        want_shapes = jax.tree.map(lambda a: tuple(a.shape), jtree)
        assert jax.tree.map(lambda t: tuple(t.shape), got) == want_shapes
        assert "mlp" not in got["layers"]
        assert ("ws_gate" in got["layers"]["moe"]) == (case == "kimi")
        for name, t in got["layers"]["moe"].items():
            want = 1.0 / np.sqrt(t.shape[-2])
            assert abs(t.std().item() / want - 1.0) < 0.1, name
        back = params_from_numpy(params_to_numpy(got), "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(got), jax.tree.leaves(back)))


# ---------------------------------------------------------------------------
# the moe family in the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["flash_mha", "attention"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case, use_kernel):
    """Prefill at S = 40 and 4 decode steps. Mixtral's smoke window is
    32, so its cache is a ring buffer of 32 slots: the prefill leaves
    positions 8-39 in slots 0-31, and the decode steps write positions
    40-43 at slots ``cur % 32`` = 8-11, over positions 16-19, which are
    still inside the window (the reference's layout, held by the
    position check against it; its slots are not ``pos % 32`` unless S
    is a multiple of the window); kimi (no window) gets 4 extra slots."""
    n_slots, pos = parity.prefill_and_decode(_setup(case), use_kernel, 40,
                                             extra=4)
    if case == "mixtral":
        assert n_slots == 32
        assert pos == list(range(8, 16)) + list(range(40, 44)) \
            + list(range(20, 40))
    else:
        assert n_slots == 44 and pos == list(range(44))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference(case, remat):
    """The loss with ``0.01 * aux_lb / L + 1e-3 * aux_z / L`` added, the
    metrics (the cross-entropy and ``aux_lb``) and every gradient."""
    met = parity.loss_and_grads(_setup(case), remat=remat)
    assert set(met) == {"loss", "aux_lb"}
    assert float(met["aux_lb"].detach()) > 0


def test_loss_sees_the_aux_terms(monkeypatch):
    """Broken control: with the port's aux losses zeroed the check
    misses."""
    def no_aux(x, p, cfg):
        out, aux = moe.moe_block(x, p, cfg)
        return out, {k: torch.zeros_like(v) for k, v in aux.items()}
    monkeypatch.setattr(model_lib, "moe_block", no_aux)
    with pytest.raises(AssertionError):
        parity.loss_and_grads(_setup("mixtral"))


def _governed(st, mails):
    """The reference's and the port's governed static agents, a RuleVoter
    on STANDARD_RULES: per side the Result values and the entry types."""
    jcfg, tcfg, jparams, tparams = st
    out = []
    for side in ("jax", "torch"):
        if side == "jax":
            agent = jax_server.build_serving_agent(jcfg, max_batch=2)
            agent.executor.env.params = jparams
            voter = JaxRuleVoter(JaxBusClient(agent.bus, "v-rule", "voter"),
                                 rules=JAX_RULES)
        else:
            agent = server.build_serving_agent(tcfg, max_batch=2,
                                               device="cpu")
            agent.executor.env.params = tparams
            voter = RuleVoter(BusClient(agent.bus, "v-rule", "voter"),
                              rules=STANDARD_RULES)
        agent.add_voter(voter, from_tail=False)
        agent.set_policy("decider", {"mode": "first_voter"})
        for text, kwargs in mails:
            agent.send_mail(text, **kwargs)
        agent.run_until_idle()
        log = agent.external_client("t", "admin").read(0)
        out.append(([e.body.get("value") for e in log
                     if e.type.name == "RESULT"],
                    [e.type.name for e in log]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_governed_static_serving_matches_reference(case):
    """Three requests in two ``serve_batch`` intents (one prompt longer
    than mixtral's window): the same generated rows and log; the port's
    prefill ran the flash path (its CPU version) once a layer."""
    st = _setup(case)
    mails = [(f"req {i}", dict(prompt_tokens=p, req_id=f"r{i}"))
             for i, p in enumerate(parity.prompts(31, (45, 3, 9),
                                                  st[1].vocab))]
    before = flash_mha.launches
    (jvals, jtypes), (tvals, ttypes) = _governed(st, mails)
    assert [v["req_ids"] for v in tvals] == [["r0", "r1"], ["r2"]]
    assert tvals == jvals
    assert ttypes == jtypes and "ABORT" not in ttypes
    assert flash_mha.launches == before  # CPU tensors take the plain path


def test_moe_block_runs_under_no_grad_and_remat_alike():
    """The routing is deterministic: the moe block under ``no_grad`` and
    under autograd gives the same bits (remat=full recomputes it in the
    backward and must route the same way)."""
    _, tcfg = parity.configs("mixtral_8x7b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    x, p = _moe_inputs(tcfg, 2, 24, seed=6)
    pt = params_from_numpy(p, "cpu")
    with torch.no_grad():
        a, _ = moe.moe_block(torch.from_numpy(x), pt, tcfg)
    xt = torch.from_numpy(x).requires_grad_()
    b, _ = moe.moe_block(xt, pt, tcfg)
    b.sum().backward()
    assert torch.equal(a, b.detach()) and torch.isfinite(xt.grad).all()
