"""The port's optimizers and gradient compression against the reference's,
on the CPU: one AdamW and one Adafactor update from the same parameters,
gradients and state (a tree with a 1-D leaf, a 2-D leaf and a stacked
(L, ...) leaf), ``lr_at`` across its schedule, global-norm clipping, and
the int8 compression round trip with its error-feedback state.

Inputs are made with numpy from a seed and handed to both sides. Both
sides are fp32 and run the same operations, but fused or vectorised
kernels may round differently, so results are held to rtol = atol = 1e-6
(a few ulps of values near 1) where not bitwise; NaN never equals NaN.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import compression as jax_comp  # noqa: E402
from repro.optim import optimizer as jax_opt  # noqa: E402
from repro_torch.models.params import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim import optimizer as opt  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=False)


def _tree(rng, scale=1.0):
    return {"norm": (scale * rng.standard_normal(16)).astype(np.float32),
            "embed": (scale * rng.standard_normal((24, 8))).astype(
                np.float32),
            "layers": {"wq": (scale * rng.standard_normal((3, 8, 2, 4))
                              ).astype(np.float32)}}


def _close(a, b, **tol):
    """a (tensors or numpy) against b (numpy), leaf by leaf."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], **tol)
        return
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    np.testing.assert_allclose(a, np.asarray(b), **dict(tol, equal_nan=False))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_reference(name):
    """From the same params, grads and a state one step in (step 3, so
    bias correction, beta2 and the schedule are all past their first
    value), one update: params, state, grad_norm and lr."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, scale=0.3)
    cfg_kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10,
                  clip_norm=1.0)
    jcfg, tcfg = jax_opt.OptimizerConfig(**cfg_kw), opt.OptimizerConfig(
        **cfg_kw)
    jinit, jupd = jax_opt.make_optimizer(jcfg)
    state = _np(jinit(params))
    # a state that is not all zeros: moments from an earlier gradient
    state = {k: (np.int32(2) if k == "step" else _np(
        _abs_tree(v, rng))) for k, v in state.items()}
    jp, js, jm = jupd(params, grads, state)

    tinit, tupd = opt.make_optimizer(tcfg)
    tstate = params_from_numpy(state, "cpu")
    tp, ts, tm = tupd(params_from_numpy(params, "cpu"),
                      params_from_numpy(grads, "cpu"), tstate)
    _close(tp, _np(jp), **TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    _close({k: v for k, v in ts.items() if k != "step"},
           {k: _np(v) for k, v in js.items() if k != "step"}, **TOL)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    # the grads (norm ~2.5) were clipped
    assert float(tm["grad_norm"]) > tcfg.clip_norm
    # the init's tree and dtypes are the reference's
    ti, ji = tinit(params_from_numpy(params, "cpu")), _np(jinit(params))
    _close({k: v for k, v in ti.items() if k != "step"},
           {k: v for k, v in ji.items() if k != "step"}, rtol=0, atol=0)


def _abs_tree(tree, rng):
    if isinstance(tree, dict):
        return {k: _abs_tree(v, rng) for k, v in tree.items()}
    return np.abs(rng.standard_normal(np.shape(tree))).astype(np.float32) \
        * 0.01


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 250])
def test_lr_schedule_matches_reference(step):
    """Step 0, inside the warmup, its end, mid-cosine, the end of the
    schedule and past it."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    j = jax_opt.lr_at(jax_opt.OptimizerConfig(**kw), jnp.int32(step))
    t = opt.lr_at(opt.OptimizerConfig(**kw),
                  torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(float(t), float(j), rtol=1e-7, atol=0,
                               equal_nan=False)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Above the limit the grads are scaled to it; below they pass."""
    g = _tree(np.random.default_rng(1))
    jg, jn = jax_opt.clip_by_global_norm(g, max_norm)
    tg, tn = opt.clip_by_global_norm(params_from_numpy(g, "cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _close(tg, _np(jg), **TOL)
    if max_norm > float(jn):
        _close(tg, g, rtol=0, atol=0)


def test_compression_round_trip_and_error_feedback():
    """Three rounds of Q(g + e) with the error carried: the dequantized
    grads and the error buffers equal the reference's, and the error is
    the residual of the round."""
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    je = jax_comp.ef_init(tree)
    te = compression.ef_init(params_from_numpy(tree, "cpu"))
    for _ in range(3):
        g = _tree(rng)
        jc, je = jax_comp.compress_grads(g, je)
        tc, te_new = compression.compress_grads(params_from_numpy(g, "cpu"),
                                                te)
        _close(tc, _np(jc), **TOL)
        _close(te_new, _np(je), **TOL)
        _close(te_new, _zip(lambda g_, e, c: (g_ + e) - c, g,
                            params_to_numpy(te), params_to_numpy(tc)),
               **TOL)
        te = te_new


def _zip(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _zip(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def test_quantize_rounds_halves_to_even():
    """Values whose quotient by the scale is exactly k + 0.5 round to the
    even neighbour on both sides (scale 1: amax 127)."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                 np.float32)
    jq, js = jax_comp.quantize(jnp.asarray(g))
    tq, ts = compression.quantize(torch.from_numpy(g))
    assert float(ts) == float(js) == 1.0
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tq.numpy(), np.array([127, 0, 2, 2, 0, -2, -2, 4, 126], np.int8))
