"""Shared checks of the port's ``Model`` against the reference's on one
smoke config, on the CPU: the reference's parameters carried over with
``params_from_numpy``, inputs made with numpy from a seed.

Tolerances (stated where they are used as well):

* logits and K/V caches: rtol = atol = 2e-4, the reference's tolerance
  for model logits (``tests/test_models.py:84-86``); cache positions
  equal;
* the loss and its metrics: rtol = atol = 1e-5 (``test_torch_train.py``'s);
* gradients: rtol = 1e-4 with atol = 4e-5 x the leaf's largest magnitude.
  ``test_torch_train.py`` holds smoke qwen3_4b and mamba2_780m at atol
  1e-5 x that magnitude, but on these configs that is the float32 noise
  of the gradient itself: the reference's jitted gradient against its own
  op-by-op one reaches 0.50-0.99 x the 1e-5 limit (gemma2 0.87, chatglm3
  0.75, codeqwen 0.86 and 0.24 at rep 1, mixtral 0.99, kimi 0.50), and
  the port's against the jitted one 0.55-1.95 x (qwen3 0.07). So the
  limit is 4x that, and ``test_the_gradient_check_sees_a_wrong_option``
  shows that it still catches a config option left out on the port's
  side;
* tokens (greedy argmaxes) equal exactly.

The audio and vlm families take their stub frontend's input from
``frontend`` (unit normal from a seed) in the prefill and the loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke as jax_smoke
from repro.models.model import Model as JaxModel
from repro.models.params import split_params
from repro.serving import server as jax_server
from repro_torch.configs.base import get_config, smoke
from repro_torch.models.model import Model
from repro_torch.models.params import (params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.serving import server

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4, equal_nan=False)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=False)
GRAD_RTOL, GRAD_ATOL = 1e-4, 4e-5


def configs(arch, **variant):
    """The reference's and the port's smoke configs of ``arch``, with
    ``variant`` replaced on both."""
    return (dataclasses.replace(jax_smoke(jax_get_config(arch)), **variant),
            dataclasses.replace(smoke(get_config(arch)), **variant))


def setup(arch, **variant):
    """(jcfg, tcfg, reference params, the same values as tensors)."""
    jcfg, tcfg = configs(arch, **variant)
    jparams, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)))
    jparams = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(jparams, "cpu")


_SETUPS = {}


def conditioned_setup(arch):
    """``setup(arch)``, made once a process, with whisper_small's ``wq``
    and ``wk`` (encoder, decoder and cross) scaled by 1/4 on both sides:
    its smoke attention scores then have a std near 1 rather than ~23,
    where its float32 results are ill-conditioned on both sides
    (``tests/test_torch_encdec_vlm.py``'s docstring gives the numbers)."""
    if arch not in _SETUPS:
        jcfg, tcfg, jparams, _ = setup(arch)
        if arch == "whisper_small":
            for tree in (jparams["enc_layers"]["attn"],
                         jparams["layers"]["attn"],
                         jparams["layers"]["cross"]):
                tree["wq"] = tree["wq"] * np.float32(0.25)
                tree["wk"] = tree["wk"] * np.float32(0.25)
        _SETUPS[arch] = (jcfg, tcfg, jparams,
                         params_from_numpy(jparams, "cpu"))
    return _SETUPS[arch]


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def close_tree(tc, jc, tol=LOGIT_TOL):
    """Every leaf of the port's cache ``tc`` against the reference's
    ``jc``: the same nested keys and shapes, integer leaves (positions)
    equal, float leaves at ``tol``."""
    if isinstance(jc, dict):
        assert isinstance(tc, dict) and tc.keys() == jc.keys()
        for k in jc:
            close_tree(tc[k], jc[k], tol)
        return
    got, want = np.asarray(tc), np.asarray(jc)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want, **tol)


def frontend(cfg, b=2, seed=3):
    """The stub frontend's input of ``cfg`` as numpy, unit normal from a
    seed: ``frame_embed`` (b, enc_seq, D) for audio, ``patch_embed`` (b,
    n_frontend_tokens, D) for vlm, nothing for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        shape, key = (b, cfg.enc_seq, cfg.d_model), "frame_embed"
    elif cfg.family == "vlm":
        shape, key = (b, cfg.n_frontend_tokens, cfg.d_model), "patch_embed"
    else:
        return {}
    return {key: rng.standard_normal(shape).astype(np.float32)}


def as_batches(arrays):
    """A batch of numpy arrays as the reference's (int32 tokens) and the
    port's (int64 tokens; float arrays kept fp32)."""
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                              else v) for k, v in arrays.items()}
    return jb, tb


def prefill_and_decode_tree(st, use_kernel, S, extra, steps=4,
                            tol=LOGIT_TOL):
    """Prefill of a (2, S) prompt behind the family's seeded frontend
    input on both sides, then ``steps`` decode steps from the prefilled
    length (the prompt plus a vlm's prefix): the logits and every leaf of
    the cache held after each (``close_tree``), all at ``tol``. Returns
    the port's last cache."""
    jcfg, tcfg, jparams, tparams = st
    jm = JaxModel(jcfg, dtype=jnp.float32)
    tm = Model(tcfg, use_kernel=use_kernel)
    jb, tb = as_batches(dict(tokens=tokens(6, (2, S), tcfg.vocab),
                             **frontend(tcfg)))
    jl, jc = jm.prefill(jparams, jb, extra_cache=extra)
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, tb, extra_cache=extra)
    assert tuple(tl.shape) == jl.shape == (2, 1, tm.vocab_pad)
    close(tl, jl, **tol)
    close_tree(tc, jc, tol)
    cur0 = S + (tcfg.n_frontend_tokens if tcfg.family == "vlm" else 0)
    tok = np.array([[3], [77]])
    for step in range(steps):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(cur0 + step))
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                    cur0 + step)
        close(tl, jl, **tol)
        close_tree(tc, jc, tol)
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    return tc


def prefill_and_decode(st, use_kernel, S, extra, steps=4):
    """``prefill_and_decode_tree`` of a model whose cache is K/V alone:
    the port's cache's slot count and the positions its slots hold after
    the last step, for the caller's checks."""
    tc = prefill_and_decode_tree(st, use_kernel, S, extra, steps)
    assert tc.keys() == {"attn"}
    return tc["attn"]["k"].shape[2], tc["attn"]["pos"][0].tolist()


def batch(vocab, b=2, s=24, seed=0):
    """tokens and labels (b, s); a fifth of the labels masked (-1)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.2] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def loss_and_grads(st, remat="none", s=24, grad_rtol=GRAD_RTOL,
                   grad_atol=GRAD_ATOL, **broken):
    """The loss, its metrics and every parameter's gradient on both sides
    (the reference at remat none), the batch with the family's seeded
    frontend input (``frontend``); the gradients at ``grad_rtol`` and
    ``grad_atol`` x each leaf's largest magnitude. Returns the port's
    metrics. ``broken`` replaces config fields on the port's side only (a
    control)."""
    jcfg, tcfg, jparams, tparams = st
    jm = JaxModel(jcfg, dtype=jnp.float32)
    tm = Model(dataclasses.replace(tcfg, **broken))
    b = dict(batch(tcfg.vocab, s=s), **frontend(tcfg))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jm.loss_fn(p, bb), has_aux=True))(jparams, b)
    leaves = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    loss, met = tm.loss_fn(leaves, as_batches(b)[1], remat=remat)
    loss.backward()
    close(float(loss.detach()), float(jloss), **LOSS_TOL)
    assert met.keys() == jmet.keys()
    for k in met:
        close(float(met[k].detach()), float(jmet[k]), **LOSS_TOL)
    jleaves = jax.tree.leaves(jgrads)   # sorted keys, as tree_leaves
    tleaves = tree_leaves(tree_map(lambda t: t.grad, leaves))
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=grad_rtol,
            atol=grad_atol * max(float(np.abs(w).max()), 1e-30),
            equal_nan=False)
    return met


def serve_batch(st, args):
    """``h_serve_batch`` on both sides; the two results must be equal."""
    jcfg, tcfg, jparams, tparams = st
    jenv = jax_server.ServeEnv(model=JaxModel(jcfg, dtype=jnp.float32),
                               params=jparams)
    tenv = server.ServeEnv(model=Model(tcfg), params=tparams, device="cpu")
    want = jax_server.h_serve_batch(dict(args), jenv)
    got = server.h_serve_batch(dict(args), tenv)
    assert got == want
    return got


def prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]
