"""The port's int8 ``kv_quant`` cache against the reference's, on the CPU:
``quantize_kv`` bitwise (ties at .5, an all-zero row), the reference's
two ``kv_quant`` tests run on both packages from the same parameters, the
prefill's int8 cache in every family with attention caches, and decode
past the window on the ring-buffered cache.

Tolerances: logits and float cache leaves at ``LOGIT_TOL`` (rtol = atol
= 2e-4, the reference's for model logits); the int8 K/V within 1 of the
reference's (an fp32 difference of ~1e-7 in ``x / scale`` moves a value
that lies on a .5 boundary to the other side), their scales at
``LOGIT_TOL``, and the dequantized values within that tolerance plus one
step of the reference's scale; positions equal; the decode softmax
within 0.05 of the exact cache's (``tests/test_models.py:158-172``).
A value that rounds to another int moves the logits by up to ~1e-2 (one
flip in the smoke qwen3 prefill moves them 3.5e-3), so each decode step
is held from the same cache on both sides: the port's step takes a copy
of the reference's cache (``step_both``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro.models import layers as jax_layers
from repro.models.model import Model as JaxModel
from repro.models.params import split_params
from repro_torch.models import layers
from repro_torch.models.model import Model

TOL = parity.LOGIT_TOL
SOFTMAX_LIMIT = 0.05  # the reference's test_kv_quant_decode_matches_exact
CACHE_FAMILIES = {"dense": "qwen3_4b", "moe": "mixtral_8x7b",
                  "hybrid": "zamba2_1p2b", "audio": "whisper_small",
                  "vlm": "internvl2_26b"}


def _models(tcfg, jcfg, quant=True):
    return (JaxModel(jcfg, dtype=jnp.float32, kv_quant=quant),
            Model(tcfg, kv_quant=quant))


def hold_int8(tc, jc, counts=None):
    """The port's cache ``tc`` against the reference's ``jc``, leaf by
    leaf: the same keys, shapes and dtypes; in each quantized K/V cache
    (one with ``k_scale``) the ints within 1, the scales at TOL and the
    dequantized values within TOL plus one step of the reference's scale;
    every other leaf as ``parity.close_tree`` holds it. Returns
    ``counts`` [ints that differ, ints] summed over the quantized
    leaves."""
    counts = [0, 0] if counts is None else counts
    if not isinstance(jc, dict):
        got, want = np.asarray(tc), np.asarray(jc)
        assert got.shape == want.shape and got.dtype == want.dtype
        parity.close_tree(tc, jc, TOL)
        return counts
    assert isinstance(tc, dict) and tc.keys() == jc.keys()
    if "k_scale" not in jc:
        for k in jc:
            hold_int8(tc[k], jc[k], counts)
        return counts
    for k in jc:
        got, want = np.asarray(tc[k]), np.asarray(jc[k])
        assert got.shape == want.shape and got.dtype == want.dtype, k
    np.testing.assert_array_equal(np.asarray(tc["pos"]),
                                  np.asarray(jc["pos"]))
    for n in ("k", "v"):
        tq = np.asarray(tc[n]).astype(np.int64)
        jq = np.asarray(jc[n]).astype(np.int64)
        ts, js = np.asarray(tc[f"{n}_scale"]), np.asarray(jc[f"{n}_scale"])
        diff = np.abs(tq - jq)
        assert diff.max() <= 1, f"{n}: ints differ by {diff.max()}"
        parity.close(ts, js, **TOL)
        want = jq * js[..., None]
        np.testing.assert_array_less(
            np.abs(tq * ts[..., None] - want),
            TOL["atol"] + TOL["rtol"] * np.abs(want) + js[..., None]
            * (1 + 1e-6))
        counts[0] += int((diff > 0).sum())
        counts[1] += diff.size
    return counts


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def step_both(jm, tm, jparams, tparams, jc, tok, cur, counts):
    """One decode step of ``tok`` (B, 1) at ``cur`` on both sides from the
    reference's cache ``jc`` (the port's step on a copy of it): the
    logits at TOL and the new caches by ``hold_int8``. Returns the
    reference's logits and new cache."""
    jl, jnew = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                              jnp.int32(cur))
    with torch.no_grad():
        tl, tnew = tm.decode_step(tparams, _as_torch(jc),
                                  torch.from_numpy(np.asarray(tok)), cur)
    assert bool(torch.isfinite(tl).all())
    parity.close(tl, jl, **TOL)
    hold_int8(tnew, jnew, counts)
    return jl, jnew


def _report(label, counts):
    print(f"{label}: {counts[0]} of {counts[1]} int8 values differ by 1 "
          f"({counts[0] / max(counts[1], 1):.2e})")


def _x_with_ties():
    """fp32 (3, 5, 4, 16), scaled normal, with an all-zero row (its scale
    is the 1e-12 term alone) and a row whose amax 127 gives scale 1.0
    exactly (1e-12 vanishes in fp32 beside 1.0), so 2.5, -3.5, 0.5 and
    1.5 sit on ties that round half to even."""
    x = 3 * np.random.default_rng(0).standard_normal((3, 5, 4, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0
    x[0, 0, 1] = 0
    x[0, 0, 1, :5] = [127, 2.5, -3.5, 0.5, 1.5]
    x[1, 2, 3, :3] = [-254, 5.0, 7.0]  # scale 2.0: 2.5 and 3.5 again
    return x


def test_quantize_kv_is_bitwise_the_reference():
    x = _x_with_ties()
    jq, js = jax_layers.quantize_kv(jnp.asarray(x))
    tq, ts = layers.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tq[0, 0, 1, :5].tolist() == [127, 2, -4, 0, 2]
    assert tq[1, 2, 3, :3].tolist() == [-127, 2, 4]
    assert ts[0, 0, 0].item() == np.float32(1e-12)
    assert not tq[0, 0, 0].any()
    deq = layers.dequantize_kv(tq, ts)
    assert deq.numpy().tobytes() == np.asarray(
        jax_layers.dequantize_kv(jq, js)).tobytes()


def _port_decode(tm, tparams, toks):
    """The port alone: decode of ``toks`` (1, S) from ``init_cache``, one
    token a step. Returns the last logits and the cache."""
    B, S = toks.shape
    tc = tm.init_cache(B, S, device="cpu")
    with torch.no_grad():
        for t in range(S):
            tl, tc = tm.decode_step(tparams, tc,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
    return tl, tc


@pytest.mark.parametrize("arch", ["qwen3_4b", "mixtral_8x7b"])
def test_kv_quant_decode_matches_exact(arch):
    """The reference's test on both packages: 10 decode steps from
    ``init_cache`` with the int8 cache and with the exact one, the port's
    softmax within 0.05 of its exact run's (and the reference's of its
    own); every int8 step held to the reference's (``step_both``)."""
    jcfg, tcfg, jparams, tparams = parity.conditioned_setup(arch)
    toks = parity.tokens(0, (1, 10), tcfg.vocab)
    (jm0, tm0), (jm, tm) = _models(tcfg, jcfg, quant=False), _models(
        tcfg, jcfg)
    exact, _ = _port_decode(tm0, tparams, toks)
    quant, tc = _port_decode(tm, tparams, toks)
    assert tc["attn"]["k"].dtype == torch.int8
    err = (torch.softmax(exact, -1) - torch.softmax(quant, -1)).abs().max()
    assert err.item() < SOFTMAX_LIMIT
    jc0, _ = split_params(jm0.init_cache(1, 10))
    jc, _ = split_params(jm.init_cache(1, 10))
    counts = [0, 0]
    for t in range(10):
        jl0, jc0 = jm0.decode_step(jparams, jc0,
                                   jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                   jnp.int32(t))
        jl, jc = step_both(jm, tm, jparams, tparams, jc, toks[:, t:t + 1],
                           t, counts)
    assert float(jnp.abs(jax.nn.softmax(jl0) - jax.nn.softmax(jl)).max()) \
        < SOFTMAX_LIMIT
    _report(arch, counts)


def test_kv_quant_prefill_then_decode():
    """The reference's test on both packages: an (1, 8) prefill with 4
    reserved slots gives an int8 cache of 12 slots; 4 greedy decode
    steps give finite logits, held to the reference's with the cache."""
    jcfg, tcfg, jparams, tparams = parity.setup("qwen3_4b")
    jm, tm = _models(tcfg, jcfg)
    toks = parity.tokens(0, (1, 8), tcfg.vocab)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        extra_cache=4)
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            extra_cache=4)
    assert tc["attn"]["k"].dtype == torch.int8
    assert tc["attn"]["k"].shape[2] == 12  # 8 prefill + 4 reserved
    counts = hold_int8(tc, jc)
    tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    for t in range(4):
        jl, jc = step_both(jm, tm, jparams, tparams, jc, tok, 8 + t, counts)
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    _report("qwen3_4b prefill + decode", counts)


def _prefill(arch, S, extra):
    """Both sides' int8 prefill of a (2, S) prompt behind the family's
    seeded frontend input; the logits held. Returns the reference's and
    the port's models, parameters and caches."""
    jcfg, tcfg, jparams, tparams = parity.conditioned_setup(arch)
    jm, tm = _models(tcfg, jcfg)
    jb, tb = parity.as_batches(dict(tokens=parity.tokens(6, (2, S),
                                                         tcfg.vocab),
                                    **parity.frontend(tcfg)))
    jl, jc = jm.prefill(jparams, jb, extra_cache=extra)
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, tb, extra_cache=extra)
    parity.close(tl, jl, **TOL)
    return (jm, jparams, jc), (tm, tparams, tc)


@pytest.mark.parametrize("family", list(CACHE_FAMILIES))
def test_prefill_int8_cache_matches_reference(family):
    """Every family with attention caches: the prefill's int8 K/V (the
    layers', the hybrid's shared block's, the audio decoder's) and their
    scales against the reference's; the audio family's encoder K/V stay
    fp32 on both sides."""
    arch = CACHE_FAMILIES[family]
    (_, _, jc), (_, _, tc) = _prefill(arch, 12, 4)
    quantized = [k for k, v in tc.items()
                 if isinstance(v, dict) and "k_scale" in v]
    assert quantized == (["shared_attn"] if family == "hybrid"
                         else ["attn"])
    if family == "audio":
        assert tc["cross_k"].dtype == tc["cross_v"].dtype == torch.float32
    _report(f"{arch} prefill", hold_int8(tc, jc))


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_1p2b"])
def test_decode_past_the_window_on_the_ring_buffer(arch):
    """A prompt of 40 past the smoke window of 32: the int8 cache is a
    ring of 32 slots, and 6 decode steps overwrite slots 8-13 with
    positions 40-45 on both sides (the hybrid's shared block likewise),
    logits and caches held after each."""
    (jm, jparams, jc), (tm, tparams, tc) = _prefill(arch, 40, 4)
    kv = "shared_attn" if arch == "zamba2_1p2b" else "attn"
    assert tc[kv]["k"].shape[2] == 32
    counts = hold_int8(tc, jc)
    tok = np.array([[3], [77]])
    for step in range(6):
        jl, jc = step_both(jm, tm, jparams, tparams, jc, tok, 40 + step,
                           counts)
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    pos = np.asarray(jc[kv]["pos"][0]).tolist()
    assert pos[8:14] == list(range(40, 46))
    # the prefill left positions 8-39 in slots 0-31, and decode writes
    # position p at slot p % 32 (the reference's ring layout)
    assert pos == list(range(8, 16)) + list(range(40, 46)) + list(
        range(22, 40))
    _report(f"{arch} past the window", counts)


@pytest.mark.parametrize("leaf", ["k_scale", "v"])
def test_the_check_sees_a_cache_off_by_one_slot(leaf):
    """Broken control: the port's scales (or ints) rolled by one slot
    must fail ``hold_int8``."""
    (_, _, jc), (_, _, tc) = _prefill("qwen3_4b", 12, 0)
    tc["attn"][leaf] = torch.roll(tc["attn"][leaf], 1, dims=2)
    with pytest.raises(AssertionError):
        hold_int8(tc, jc)
