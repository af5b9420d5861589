"""The port's dense static generation path against the reference's, on the
CPU, at the smoke ``qwen3_4b`` in fp32 with the reference's parameters
carried over (``params_from_numpy``): the KV-cache layers
(``cache_update``, ``decode_attention_block``), the dense ``Model`` (``_window_array``,
``cache_len``, ``init_cache``, ``prefill``, ``decode_step``) and the
governed static serving of the dense family.

Inputs are made with numpy from a seed and handed to both sides. Logits
and caches are held at rtol = atol = 2e-4, the reference's tolerance for
model logits (``tests/test_models.py:84-86``); the layers at 2e-5, its
kernel-vs-oracle tolerance. Tokens are greedy argmaxes and must be equal
exactly. ``use_kernel=True`` (the default) sends the prefill's attention
through ``flash_mha``, whose CPU tensors take its plain version;
``use_kernel=False`` through the model's ``attention``.
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
from repro.core.voter import RuleVoter as JaxRuleVoter  # noqa: E402
from repro.core.voter import STANDARD_RULES as JAX_RULES  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.serving import server as jax_server  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.core.acl import BusClient  # noqa: E402
from repro_torch.core.voter import STANDARD_RULES, RuleVoter  # noqa: E402
from repro_torch.kernels.flash_attention import flash_mha  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.model import INF_WINDOW, Model  # noqa: E402
from repro_torch.models.params import (params_from_numpy,  # noqa: E402
                                       unstack_layers)
from repro_torch.serving import server  # noqa: E402

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def qwen3():
    jcfg = jax_smoke(jax_get_config("qwen3_4b"))
    tcfg = smoke(get_config("qwen3_4b"))
    jparams, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_cache(tc, jc, **tol):
    """k/v within ``tol``; pos equal."""
    assert tc.keys() == jc.keys() == {"k", "v", "pos"}
    _close(tc["k"], jc["k"], **tol)
    _close(tc["v"], jc["v"], **tol)
    np.testing.assert_array_equal(np.asarray(tc["pos"]),
                                  np.asarray(jc["pos"]))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _kv_cache(seed, b, s, kv, dh, n_written):
    rng = np.random.default_rng(seed)
    f = np.float32
    pos = np.full(s, -1, np.int32)
    pos[:n_written] = np.arange(n_written)
    return {"k": rng.standard_normal((b, s, kv, dh)).astype(f),
            "v": rng.standard_normal((b, s, kv, dh)).astype(f), "pos": pos}


@pytest.mark.parametrize("cur,window", [(3, None), (9, None), (5, INF_WINDOW),
                                        (11, INF_WINDOW), (13, 4)],
                         ids=["slot_cur", "past_end_clamped", "inf_window",
                              "ring_wrap", "window"])
def test_cache_update_matches_reference(cur, window):
    cache = _kv_cache(1, 2, 8, 2, 16, 6)
    rng = np.random.default_rng(2)
    k_new, v_new = (rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
                    for _ in range(2))
    want = jax_layers.cache_update({n: jnp.asarray(a) for n, a in
                                    cache.items()}, jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.int32(cur), window)
    tc = {n: torch.from_numpy(a) for n, a in cache.items()}
    got = layers.cache_update(tc, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), cur, window)
    for n in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        np.testing.assert_array_equal(tc[n].numpy(), cache[n])  # untouched


def test_the_quantized_cache_is_not_ported():
    """The quantized cache's update matches the reference's. (The name is
    the one this case had while the port refused a quantized cache; it is
    kept so that the case stays the same test.) A quantized cache (int8
    k/v beside fp32 ``k_scale``/``v_scale``)
    takes the reference's int8 branch: the token's ints, scales and
    position written at the ring slot bitwise as the reference writes
    them, the given cache untouched."""
    rng = np.random.default_rng(3)
    cache = _kv_cache(1, 2, 4, 2, 8, 2)
    for n in ("k", "v"):
        cache[n] = rng.integers(-127, 128, cache[n].shape).astype(np.int8)
        cache[f"{n}_scale"] = rng.random(cache[n].shape[:-1]).astype(
            np.float32)
    k_new, v_new = (rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
                    for _ in range(2))
    want = jax_layers.cache_update({n: jnp.asarray(a) for n, a in
                                    cache.items()}, jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.int32(6), 4)
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got = layers.cache_update(tc, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), 6, 4)
    assert got.keys() == cache.keys()
    for n in cache:
        assert got[n].numpy().tobytes() == np.asarray(want[n]).tobytes(), n
        np.testing.assert_array_equal(tc[n].numpy(), cache[n])  # untouched
    assert got["k"].dtype == torch.int8 and got["pos"][2] == 6


@pytest.mark.parametrize("cur,window", [(6, INF_WINDOW), (8, 3), (10, None)],
                         ids=["inf_window", "window", "no_window"])
def test_decode_attention_block_matches_reference(qwen3, cur, window):
    jcfg, tcfg, jparams, tparams = qwen3
    D, Kv, Dh = tcfg.d_model, tcfg.n_kv_heads, tcfg.head_dim
    cache = _kv_cache(3, 2, 8, Kv, Dh, 6)
    x = np.random.default_rng(4).standard_normal((2, 1, D)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    jy, jc = jax_layers.decode_attention_block(
        jnp.asarray(x), jp, jcfg,
        cache={n: jnp.asarray(a) for n, a in cache.items()},
        cur=jnp.int32(cur), window=window)
    ty, tc = layers.decode_attention_block(
        torch.from_numpy(x), unstack_layers(tparams["layers"]["attn"])[0],
        tcfg,
        cache={n: torch.from_numpy(a) for n, a in cache.items()}, cur=cur,
        window=window)
    _close(ty, jy, **LAYER_TOL)
    _close_cache(tc, jc, **LAYER_TOL)


# ---------------------------------------------------------------------------
# the dense Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [
    {}, {"window": 8}, {"window": 8, "local_global_pattern": True}],
    ids=["no_window", "window", "local_global"])
def test_window_array_and_cache_len_match_reference(variant):
    jcfg = dataclasses.replace(jax_smoke(jax_get_config("qwen3_4b")),
                               **variant)
    tcfg = dataclasses.replace(smoke(get_config("qwen3_4b")), **variant)
    jm, tm = JaxModel(jcfg, dtype=jnp.float32), Model(tcfg)
    assert tm._window_array() == np.asarray(jm._window_array()).tolist()
    assert model_lib.INF_WINDOW == INF_WINDOW == 1 << 30
    for s in (3, 8, 20):
        assert tm.cache_len(s) == jm.cache_len(s)


def test_init_cache_matches_reference(qwen3):
    jcfg, tcfg, _, _ = qwen3
    jc, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init_cache(3, 20))
    tc = Model(tcfg).init_cache(3, 20, device="cpu")
    assert tc.keys() == jc.keys() == {"attn"}
    for n in ("k", "v", "pos"):
        assert tuple(tc["attn"][n].shape) == jc["attn"][n].shape
        np.testing.assert_array_equal(tc["attn"][n].numpy(),
                                      np.asarray(jc["attn"][n]))
    assert tc["attn"]["pos"].dtype == torch.int32
    assert (tc["attn"]["pos"] == -1).all()


@pytest.mark.parametrize("extra", [0, 5])
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["flash_mha", "attention"])
def test_prefill_and_decode_match_reference(qwen3, use_kernel, extra):
    """Logits and every layer's k/v/pos after the prefill and after each of
    three decode steps. With ``extra_cache=0`` the cache holds exactly the
    prompt, and the decode steps wrap to the ring-buffer slot
    ``cur % S_cache`` (0, 1, 2), as in the reference's layer scan, where
    the window is INF_WINDOW and never None."""
    jcfg, tcfg, jparams, tparams = qwen3
    jm, tm = JaxModel(jcfg, dtype=jnp.float32), Model(tcfg,
                                                      use_kernel=use_kernel)
    S = 13
    toks = _tokens(6, (2, S), tcfg.vocab)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        extra_cache=extra)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        extra_cache=extra)
    assert tuple(tl.shape) == jl.shape == (2, 1, tm.vocab_pad)
    _close(tl, jl, **LOGIT_TOL)
    assert tc.keys() == jc.keys() == {"attn"}
    assert tuple(tc["attn"]["k"].shape) == (tcfg.n_layers, 2, S + extra,
                                            tcfg.n_kv_heads, tcfg.head_dim)
    _close_cache(tc["attn"], jc["attn"], **LOGIT_TOL)
    tok = np.array([[3], [77]])
    for step in range(3):
        cur = S + step
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(cur))
        tl, tc2 = tm.decode_step(tparams, tc, torch.from_numpy(tok), cur)
        assert tc2 is not tc and tc2["attn"]["k"] is not tc["attn"]["k"]
        tc = tc2
        _close(tl, jl, **LOGIT_TOL)
        _close_cache(tc["attn"], jc["attn"], **LOGIT_TOL)
        slot = cur % (S + extra)
        assert slot == (step if extra == 0 else cur)
        assert (tc["attn"]["pos"][:, slot] == cur).all()
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]


def test_prefill_chunked_attention_matches_reference(qwen3, monkeypatch):
    """Above DENSE_ATTN_MAX_KV keys the plain prefill takes the chunked
    online softmax, on both sides (the limit lowered to 8 here, with
    4-key chunks, so that a smoke prompt crosses it)."""
    jcfg, tcfg, jparams, tparams = qwen3
    monkeypatch.setattr(jax_layers, "DENSE_ATTN_MAX_KV", 8)
    monkeypatch.setattr(layers, "DENSE_ATTN_MAX_KV", 8)
    toks = _tokens(7, (2, 11), tcfg.vocab)
    jl, jc = JaxModel(jcfg, dtype=jnp.float32).prefill(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, kv_chunk=4)
    tl, tc = Model(tcfg, use_kernel=False).prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, kv_chunk=4)
    _close(tl, jl, **LOGIT_TOL)
    _close_cache(tc["attn"], jc["attn"], **LOGIT_TOL)


def test_prefill_decode_consistency(qwen3):
    """Decoding S+1 tokens one by one from an empty cache equals the
    teacher-forced prefill's last logits (the reference's
    test_prefill_decode_consistency, on the port)."""
    _, tcfg, _, tparams = qwen3
    model = Model(tcfg)
    toks = torch.from_numpy(_tokens(8, (1, 13), tcfg.vocab))
    full_logits, _ = model.prefill(tparams, {"tokens": toks})
    cache = model.init_cache(1, 13, device="cpu")
    for t in range(13):
        logits, cache = model.decode_step(tparams, cache, toks[:, t:t + 1], t)
    _close(logits[:, 0], full_logits[:, -1], **LOGIT_TOL)


# ---------------------------------------------------------------------------
# governed static serving of the dense family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs(qwen3):
    jcfg, tcfg, jparams, tparams = qwen3
    jenv = jax_server.ServeEnv(model=JaxModel(jcfg, dtype=jnp.float32),
                               params=jparams)
    tenv = server.ServeEnv(model=Model(tcfg), params=tparams, device="cpu")
    return jenv, tenv


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("lens,extra", [
    ((5, 9, 2), {}),                                   # ragged: left pad
    ((7, 3), {"pad_batch": 4}),                        # dummy rows dropped
    ((4, 4, 4), {"pad_batch": 2, "req_ids": ["a", "b", "c"]}),
], ids=["ragged", "pad_batch", "req_ids"])
def test_h_serve_batch_matches_reference(qwen3, envs, lens, extra):
    tcfg = qwen3[1]
    jenv, tenv = envs
    args = {"prompts": _prompts(len(lens), lens, tcfg.vocab),
            "max_new_tokens": 4, **extra}
    want = jax_server.h_serve_batch(dict(args), jenv)
    got = server.h_serve_batch(dict(args), tenv)
    assert got == want
    assert got["prefill_len"] == max(lens)
    assert len(got["generated"]) == len(lens)


def test_left_pad_with_token_zero_is_attended(qwen3, envs):
    """Dense attention does not mask the left pad either: a short prompt
    served beside a long one is continued from the zero-padded sequence,
    on both sides."""
    tcfg = qwen3[1]
    jenv, tenv = envs
    short, long_ = _prompts(21, (3, 11), tcfg.vocab)
    args = {"prompts": [short, long_], "max_new_tokens": 3}
    got = server.h_serve_batch(dict(args), tenv)
    assert got == jax_server.h_serve_batch(dict(args), jenv)
    padded = server.h_serve_batch(
        {"prompts": [[0] * 8 + short], "max_new_tokens": 3}, tenv)
    assert got["generated"][0] == padded["generated"][0]


def _governed(qwen3, policy, mails, **agent_kw):
    """The reference's and the port's governed static agents side by side,
    a RuleVoter on STANDARD_RULES; per side the Result values and the log's
    entry types."""
    jcfg, tcfg, jparams, tparams = qwen3
    out = []
    for side in ("jax", "torch"):
        if side == "jax":
            agent = jax_server.build_serving_agent(jcfg, **agent_kw)
            agent.executor.env.params = jparams
            voter = JaxRuleVoter(JaxBusClient(agent.bus, "v-rule", "voter"),
                                 rules=JAX_RULES)
        else:
            agent = server.build_serving_agent(tcfg, device="cpu",
                                               **agent_kw)
            agent.executor.env.params = tparams
            voter = RuleVoter(BusClient(agent.bus, "v-rule", "voter"),
                              rules=STANDARD_RULES)
        agent.add_voter(voter, from_tail=False)
        agent.set_policy("decider", {"mode": "first_voter"})
        if policy:
            agent.set_policy("voter:rule", policy)
        for text, kwargs in mails:
            agent.send_mail(text, **kwargs)
        agent.run_until_idle()
        log = agent.external_client("t", "admin").read(0)
        out.append(([e.body.get("value") for e in log
                     if e.type.name == "RESULT"],
                    [e.type.name for e in log]))
    return out


def test_governed_dense_static_serving_matches_reference(qwen3):
    mails = [(f"req {i}", dict(prompt_tokens=p, req_id=f"r{i}"))
             for i, p in enumerate(_prompts(31, (6, 3, 9, 4, 5),
                                            qwen3[1].vocab))]
    (jvals, jtypes), (tvals, ttypes) = _governed(qwen3, None, mails,
                                                 max_batch=2, pad_batch=2)
    assert [v["req_ids"] for v in tvals] == [["r0", "r1"], ["r2", "r3"],
                                             ["r4"]]
    assert tvals == jvals  # the same generated rows, batch for batch
    assert ttypes == jtypes and "ABORT" not in ttypes


def test_denylisted_dense_serve_batch_is_aborted(qwen3):
    mails = [(f"req {i}", dict(prompt_tokens=p, req_id=f"r{i}"))
             for i, p in enumerate(_prompts(32, (6, 3, 9), qwen3[1].vocab))]
    before = flash_mha.launches
    (jvals, jtypes), (tvals, ttypes) = _governed(
        qwen3, {"kind_denylist": ["serve_batch"]}, mails, max_batch=2)
    assert tvals == jvals == []  # nothing executed
    assert ttypes == jtypes
    assert ttypes.count("ABORT") == 2 and "COMMIT" not in ttypes
    assert flash_mha.launches == before
