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


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def close_cache(tc, jc):
    assert tc.keys() == jc.keys() == {"k", "v", "pos"}
    close(tc["k"], jc["k"], **LOGIT_TOL)
    close(tc["v"], jc["v"], **LOGIT_TOL)
    np.testing.assert_array_equal(np.asarray(tc["pos"]),
                                  np.asarray(jc["pos"]))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def prefill_and_decode(st, use_kernel, S, extra, steps=4):
    """Prefill of a (2, S) batch and ``steps`` decode steps on both sides:
    the logits and every layer's K/V cache after each. Returns the port's
    cache's slot count and the positions the steps wrote, for the caller's
    checks."""
    jcfg, tcfg, jparams, tparams = st
    jm, tm = JaxModel(jcfg, dtype=jnp.float32), Model(tcfg,
                                                      use_kernel=use_kernel)
    toks = tokens(6, (2, S), tcfg.vocab)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        extra_cache=extra)
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            extra_cache=extra)
    assert tuple(tl.shape) == jl.shape == (2, 1, tm.vocab_pad)
    close(tl, jl, **LOGIT_TOL)
    assert tc.keys() == jc.keys() == {"attn"}
    close_cache(tc["attn"], jc["attn"])
    tok = np.array([[3], [77]])
    for step in range(steps):
        cur = S + step
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(cur))
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok), cur)
        close(tl, jl, **LOGIT_TOL)
        close_cache(tc["attn"], jc["attn"])
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    return tc["attn"]["k"].shape[2], tc["attn"]["pos"][0].tolist()


def batch(vocab, b=2, s=24, seed=0):
    """tokens and labels (b, s); a fifth of the labels masked (-1)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.2] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def loss_and_grads(st, remat="none", s=24, **broken):
    """The loss, its metrics and every parameter's gradient on both sides
    (the reference at remat none). Returns the port's metrics. ``broken``
    replaces config fields on the port's side only (a control)."""
    jcfg, tcfg, jparams, tparams = st
    jm = JaxModel(jcfg, dtype=jnp.float32)
    tm = Model(dataclasses.replace(tcfg, **broken))
    b = batch(tcfg.vocab, s=s)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jm.loss_fn(p, bb), has_aux=True))(jparams, b)
    leaves = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    loss, met = tm.loss_fn(leaves, {k: torch.from_numpy(v).long()
                                    for k, v in b.items()}, remat=remat)
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
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(w).max()), 1e-30),
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
