"""The port's training path against the reference's, on the CPU: the
self-attention block, the chunked attention's backward memory (each chunk
recomputed, as the reference's ``jax.checkpoint``) and the loss at 4096
keys, the plain SSD's gradient, ``Model.loss_fn`` and its gradients
(dense and ssm, remat none / dots / full), the data pipeline,
``params_to_numpy``, N-step trajectories through ``make_train_step``
(both optimizers, microbatches 1 and 2, compression on and off), a
microbatch count that does not divide the batch (refused on both sides)
and the checkpoint cross-restore in both directions.

Inputs and parameters are made with numpy (or by the reference's
initializer) from a seed and handed to both sides. Both are fp32 and sum
in another order (XLA vs ATen CPU kernels), so equality to the last bit is
not expected. Tolerances:

* layer outputs, losses: rtol = atol = 1e-5 (test_torch_layers.py's);
* gradients: rtol = 1e-4, atol = 1e-5 x the leaf's largest magnitude
  (a backward sums over the batch and the sequence, so a few ulps of
  the largest terms reach the small entries);
* trajectories (6 steps, lr 1e-2): losses rtol = 1e-4; parameters
  atol = 1e-4 (a few steps of lr x a unit-scale update, each moved by the
  gradients' differences) and rtol = 1e-4;
* the SSD gradient against the reference at chunk 64: rtol = atol = 1e-4;
* with the int8 gradient compression on, the losses as above, but the
  state only leaf by leaf: each parameter leaf's distance from the
  reference's within 2e-2 of the size of the reference's total update,
  each optimizer-state leaf within 2e-2 of its size, and the
  error-feedback buffers finite. Rounding to the int8 grid is
  discontinuous: where g / scale lies within an ulp of a half step, the
  two sides' ulp-level gradient differences round it to neighbouring
  integers, that entry's update and error feedback then differ by a whole
  quantization step, and the buffers of the small leaves (the norms)
  decorrelate within a few steps. A broken control shows that these
  limits still catch the compression left out on one side.
  ``test_torch_optim.py`` holds the compression itself, error feedback
  included, on equal inputs.

NaN never equals NaN (``equal_nan=False``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke as jax_smoke  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro.optim.optimizer import \
    OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.train import train_step as jax_train_step  # noqa: E402
from repro.train.checkpoint import \
    CheckpointStore as JaxCheckpointStore  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra_plain  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_numpy, params_to_numpy)
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.checkpoint import CheckpointStore  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=False)
TRAJ_LOSS_TOL = dict(rtol=1e-4, atol=0, equal_nan=False)
TRAJ_PARAM_TOL = dict(rtol=1e-4, atol=1e-4, equal_nan=False)
SSD_GRAD_TOL = dict(rtol=1e-4, atol=1e-4, equal_nan=False)
FLIP_STATE_RTOL = 2e-2


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close_tree(got, want, path="", grad=False, **tol):
    """got (tensors) against want (numpy), leaf by leaf; with ``grad``
    the atol scales with the leaf's largest magnitude."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}", grad, **tol)
        return
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert g.shape == want.shape and g.dtype == want.dtype, path
    if grad:
        tol = dict(tol, atol=tol["atol"] * max(float(np.abs(want).max()),
                                               1e-30))
    np.testing.assert_allclose(g, want, err_msg=path,
                               **dict(tol, equal_nan=False))


def _close_state(got, want, init, flips=False):
    """A train state against the reference's: to TRAJ_PARAM_TOL, or with
    ``flips`` (the int8 compression on) as the module docstring says;
    ``init`` is the initial parameter tree."""
    assert set(got) == set(want)
    if not flips:
        _close_tree(got, want, **TRAJ_PARAM_TOL)
        return
    for k in want:
        for (path, g), (_, w) in zip(_flat(got[k]), _flat(want[k])):
            g = g.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, path
            assert np.isfinite(g).all(), path
            if k == "ef" or not w.ndim:
                continue
            ref = w - _flat_dict(init)[path] if k == "params" else w
            err = np.linalg.norm(g - w) / max(np.linalg.norm(ref), 1e-30)
            assert err <= FLIP_STATE_RTOL, (k, path, err)


def _flat_dict(tree):
    return dict(_flat(tree))


def _models(arch):
    jcfg, tcfg = jax_smoke(jax_get_config(arch)), smoke(get_config(arch))
    return JaxModel(jcfg, dtype=jnp.float32), Model(tcfg, torch.float32)


def _params(jmodel, seed=0):
    return _np(split_params(jmodel.init(jax.random.PRNGKey(seed)))[0])


def _batch(vocab, b=4, s=16, seed=0):
    """tokens and labels (b, s); a few labels are -1 (masked)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.2] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5], ids=["causal", "window5"])
def test_self_attention_block_matches_reference(window):
    jcfg, tcfg = jax_smoke(jax_get_config("qwen3_4b")), smoke(
        get_config("qwen3_4b"))
    rng = np.random.default_rng(3)
    D, H, Kv, Dh = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    p = {"wq": rng.standard_normal((D, H, Dh)) / 8,
         "wk": rng.standard_normal((D, Kv, Dh)) / 8,
         "wv": rng.standard_normal((D, Kv, Dh)) / 8,
         "wo": rng.standard_normal((H, Dh, D)) / 4,
         "q_norm": rng.standard_normal(Dh) * 0.1,
         "k_norm": rng.standard_normal(Dh) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = jl.self_attention_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
        positions=jnp.asarray(pos), window=window)
    got = tl.self_attention_block(
        torch.from_numpy(x), params_from_numpy(p, "cpu"), tcfg,
        positions=torch.from_numpy(pos.copy()).long(), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the chunked attention's backward memory
# ---------------------------------------------------------------------------

def _saved_bytes(fn, q, k, v, pos):
    """Bytes of the distinct storages that autograd saves for the backward
    of ``fn`` (each storage counted once, however many views of it are
    saved), and the gradients of q, k and v."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = fn(*leaves, pos_q=pos, pos_k=pos, causal=True, kv_chunk=1024)
    o.square().sum().backward()
    return sum(saved.values()), [t.grad for t in leaves]


def _unchecked_chunks(q, k, v, *, pos_q, pos_k, causal, kv_chunk):
    """Broken control: the chunk loop without the checkpoint (as the port
    ran it before), the same ``_chunk_math`` on the same chunks."""
    B, Sq, H, Dh = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    qg = q.reshape(B, Sq, Kv, rep, Dh).float() / np.sqrt(Dh)
    m = torch.full((B, Kv, rep, Sq), -np.inf)
    l = torch.zeros((B, Kv, rep, Sq))
    acc = torch.zeros((B, Sq, Kv, rep, Dh))
    for c0 in range(0, k.shape[1], kv_chunk):
        m, l, acc = tl._chunk_math(
            qg, pos_q, k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk],
            pos_k[:, c0:c0 + kv_chunk], m, l, acc, causal=causal,
            window=None, softcap=None)
    l = torch.clamp(l, min=1e-20).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(B, Sq, H, Dh)


def test_chunked_attention_saves_one_chunk_for_the_backward():
    """q (1, 4096, 2, 16), k/v (1, 4096, 1, 16), 1024-key chunks, causal.
    With each chunk under ``torch.utils.checkpoint`` the backward keeps,
    per chunk, its inputs and the carried m, l (B, Kv, rep, Sq) and acc
    (B, Sq, Kv, rep, Dh), and recomputes the chunk's scores. The bound:
    q, k, v, the scaled q and the positions once; per chunk m, l, acc and
    its keys, values and positions; and one chunk's scores (B, Kv, rep,
    Sq, 1024) of slack for what runs outside the chunks: 38.1 MB, where
    the full score matrix alone is 134.2 MB. The loop without the
    checkpoint (the broken control) saves every chunk's softmax and must
    exceed the bound; both give the same gradients to the bit."""
    rng = np.random.default_rng(9)
    S, H, Kv, Dh, C = 4096, 2, 1, 16, 1024
    q = torch.from_numpy(rng.standard_normal((1, S, H, Dh)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, S, Kv, Dh)).astype(
        np.float32)) for _ in range(2))
    pos = torch.arange(S)[None]
    f4, i8 = 4, 8
    n_chunks = S // C
    carried = f4 * (2 * Kv * H * S + S * H * Dh)          # m, l, acc
    chunk_in = 2 * f4 * C * Kv * Dh + i8 * C              # k, v, pos
    once = f4 * (2 * q.numel() + 2 * k.numel()) + i8 * S  # q, qg, k, v, pos
    bound = once + n_chunks * (carried + chunk_in) + f4 * H * S * C
    assert bound == 38_076_416
    got, grads = _saved_bytes(tl.attention_chunked, q, k, v, pos)
    assert got <= bound, (got, bound)
    broken, broken_grads = _saved_bytes(_unchecked_chunks, q, k, v, pos)
    assert broken > bound, (broken, bound)
    for g, b in zip(grads, broken_grads):
        assert torch.equal(g, b)


def test_loss_and_grads_at_4096_keys_match_reference():
    """Smoke qwen3_4b over one row of 4096 tokens: every layer's attention
    takes the chunked path (4096 keys, above DENSE_ATTN_MAX_KV) on both
    sides, the port's under the checkpoint. The loss and every gradient
    at the training tolerances above."""
    jmodel, tmodel = _models("qwen3_4b")
    params = _params(jmodel)
    batch = _batch(tmodel.cfg.vocab, b=1, s=4096, seed=2)
    assert 4096 > tl.DENSE_ATTN_MAX_KV
    (jloss, _), jgrads = _jax_value_and_grad(jmodel, "none")(params, batch)
    tparams = _map(torch.Tensor.requires_grad_,
                   params_from_numpy(params, "cpu"))
    loss, _ = tmodel.loss_fn(tparams, _tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    _close_tree(_map(lambda p: p.grad, tparams), _np(jgrads), grad=True,
                rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the plain SSD's gradient
# ---------------------------------------------------------------------------

def _ssd_grad_inputs(s=256, h=2, p=4, n=4):
    """mamba2's initial A = -exp(A_log = 0) = -1 and dt = softplus(0 +
    dt_bias = 0); one group."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, s, h, p)) * 0.5).astype(np.float32)
    dt = np.full((1, s, h), np.log(2.0), np.float32)  # softplus(0)
    A = np.full(h, -1.0, np.float32)
    B = (rng.standard_normal((1, s, 1, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((1, s, 1, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _jax_ssd_dt_grad(x, dt, A, B, C, chunk):
    def f(dt_):
        return jax_ssm.ssd_chunked(jnp.asarray(x), dt_, jnp.asarray(A),
                                   jnp.asarray(B), jnp.asarray(C),
                                   chunk=chunk)[0].sum()
    return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(dt)))


def _torch_ssd_dt_grad(x, dt, A, B, C, chunk):
    dt_t = torch.from_numpy(dt.copy()).requires_grad_()
    y, _ = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (x,)), dt_t,
                           torch.from_numpy(A), torch.from_numpy(B),
                           torch.from_numpy(C), chunk=chunk)
    y.sum().backward()
    return dt_t.grad.numpy()


def test_ssd_gradient_is_finite_at_chunk_256():
    """The reference masks ``exp`` after taking it, and its gradient is
    NaN at chunk 256 (the upper triangle's segment sums reach ~177, so
    exp overflows and the backward gives 0 * inf); the port masks before
    the exp and its gradient is finite. At chunk 64 (no overflow) both
    are finite and agree."""
    inputs = _ssd_grad_inputs()
    assert np.isnan(_jax_ssd_dt_grad(*inputs, chunk=256)).any()
    got = _torch_ssd_dt_grad(*inputs, chunk=256)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(_torch_ssd_dt_grad(*inputs, chunk=64),
                               _jax_ssd_dt_grad(*inputs, chunk=64),
                               **SSD_GRAD_TOL)
    # the chunking does not change the function: same gradient at 256
    np.testing.assert_allclose(got, _jax_ssd_dt_grad(*inputs, chunk=64),
                               **SSD_GRAD_TOL)


def test_ssd_intra_plain_forward_bits_unchanged():
    """Masking before the exp gives the same forward bits as the
    reference's order (exp, then a where that selects 0 above the
    diagonal): exp(-inf) is exactly 0, and the lower triangle is the
    same exp of the same sums."""
    x, dt, A, B, C = _ssd_grad_inputs()
    q = 256
    xc, dtc = torch.from_numpy(x).reshape(1, 1, q, 2, 4), torch.from_numpy(
        dt).reshape(1, 1, q, 2)
    Bc, Cc = (torch.from_numpy(t).reshape(1, 1, q, 1, 4) for t in (B, C))
    a = torch.from_numpy(A)
    y, states, decay = ssd_intra_plain(xc, dtc, a, Bc, Cc)
    # the reference's order, on the same sums
    cs = torch.cumsum(dtc * a, dim=2)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool).tril()[None, None, :, :,
                                                      None]
    assert torch.isinf(torch.exp(seg)).any()
    L_ref = torch.where(tri, torch.exp(seg), 0.0)
    ch, bh = (t.repeat_interleave(2, dim=3) for t in (Cc, Bc))
    cb = torch.einsum("bcthn,bcuhn->bctuh", ch, bh)
    y_ref = torch.einsum("bctuh,bcuh,bcuhp->bcthp", cb * L_ref, dtc, xc)
    assert torch.equal(y, y_ref)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

_JAX_GRAD = {}


def _jax_value_and_grad(jmodel, remat):
    key = (jmodel.cfg.arch_id, remat)
    if key not in _JAX_GRAD:
        _JAX_GRAD[key] = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, b, remat=remat), has_aux=True))
    return _JAX_GRAD[key]


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_780m"])
def test_loss_and_grads_match_reference(arch, remat):
    """Smoke qwen3_4b (dense) and mamba2_780m (ssm, two SSD chunks of 16):
    the loss and every parameter's gradient, with a fifth of the labels
    masked. Every remat policy gives the reference's loss and gradients
    (the reference's remat=none)."""
    jmodel, tmodel = _models(arch)
    params = _params(jmodel)
    batch = _batch(tmodel.cfg.vocab, s=32)
    (jloss, _), jgrads = _jax_value_and_grad(jmodel, "none")(params, batch)
    tparams = _map(torch.Tensor.requires_grad_,
                   params_from_numpy(params, "cpu"))
    loss, metrics = tmodel.loss_fn(tparams, _tbatch(batch), remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert torch.equal(metrics["loss"], loss)
    _close_tree(_map(lambda p: p.grad, tparams), _np(jgrads), grad=True,
                rtol=1e-4, atol=1e-5)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_loss_masks_labels_and_runs_no_kernel(monkeypatch):
    """All labels masked: the loss is 0 (the reference's max(count, 1)).
    The loss runs the plain SSD even where the model asks for the kernel:
    the kernel's wrapper is never called."""
    def no_kernel(*args):
        raise AssertionError("the loss called the SSD kernel's wrapper")
    monkeypatch.setattr(ssm, "ssd_intra", no_kernel)
    jmodel, tmodel = _models("mamba2_780m")
    assert tmodel.use_kernel
    batch = _batch(tmodel.cfg.vocab)
    batch["labels"][:] = -1
    params = _params(jmodel)
    jloss, _ = jmodel.loss_fn(params, batch)
    tloss, _ = tmodel.loss_fn(params_from_numpy(params, "cpu"),
                              _tbatch(batch))
    assert float(tloss) == float(jloss) == 0.0


# ---------------------------------------------------------------------------
# data pipeline and parameter conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_pipeline_is_the_reference(shard):
    cfg = dict(vocab=97, seq_len=12, global_batch=4, seed=3)
    j = jax_pipeline.TokenPipeline(jax_pipeline.DataConfig(**cfg), *shard)
    t = pipeline.TokenPipeline(pipeline.DataConfig(**cfg), *shard)
    for cursor in (0, 5, 10_000_000):
        jb, tb = j.batch_at(cursor), t.batch_at(cursor)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype


def test_params_to_numpy_is_lossless():
    tree = init_params(smoke(get_config("qwen3_4b")),
                       torch.Generator().manual_seed(0), "cpu")
    back = params_from_numpy(params_to_numpy(tree), "cpu")
    for (k, a), (_, b) in zip(_flat(tree), _flat(back)):
        assert torch.equal(a, b) and a.dtype == b.dtype, k
    assert isinstance(params_to_numpy(tree)["layers"]["attn"]["wq"],
                      np.ndarray)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# trajectories through make_train_step
# ---------------------------------------------------------------------------

STEPS = 6


def _step_fns(jmodel, tmodel, opt_name, mb, compress, remat="none"):
    okw = dict(name=opt_name, lr=1e-2, warmup_steps=2, total_steps=10)
    skw = dict(remat=remat, microbatches=mb, compress_grads=compress)
    jinit, jstep = jax_train_step.make_train_step(
        jmodel, JaxOptimizerConfig(**okw), jax_train_step.StepConfig(**skw))
    tinit, tstep = train_step.make_train_step(
        tmodel, OptimizerConfig(**okw), train_step.StepConfig(**skw))
    return jinit, jax.jit(jstep), tinit, tstep


def _run(jstep, tstep, jstate, tstate, vocab, cursors):
    jl_, tl_ = [], []
    for c in cursors:
        batch = _batch(vocab, seed=100 + c)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _tbatch(batch))
        jl_.append(float(jm["loss"]))
        tl_.append(float(tm["loss"]))
    return jstate, tstate, jl_, tl_


@pytest.mark.parametrize("opt_name,mb,compress", [
    ("adamw", 1, False), ("adamw", 2, True), ("adafactor", 1, True),
    ("adafactor", 2, False)])
def test_trajectory_matches_reference(opt_name, mb, compress):
    """Six steps from the same parameters on the same batches: the
    losses, the last step's metrics and the final state (params,
    optimizer state, error feedback). With compression, a broken control:
    the port's run without it must miss the limits that the compressed
    run meets."""
    jmodel, tmodel = _models("qwen3_4b")
    params = _params(jmodel)
    jinit, jstep, tinit, tstep = _step_fns(jmodel, tmodel, opt_name, mb,
                                           compress)
    jstate, tstate = jinit(params), tinit(params_from_numpy(params, "cpu"))
    jstate, tstate, jl_, tl_ = _run(jstep, tstep, jstate, tstate,
                                    tmodel.cfg.vocab, range(STEPS))
    np.testing.assert_allclose(tl_, jl_, **TRAJ_LOSS_TOL)
    assert tl_[-1] < tl_[0]
    _close_state(tstate, _np(jstate), params, flips=compress)
    assert set(tstate) == ({"params", "opt", "ef"} if compress
                           else {"params", "opt"})
    if compress:
        _, _, binit, bstep = _step_fns(jmodel, tmodel, opt_name, mb, False)
        bstate = binit(params_from_numpy(params, "cpu"))
        bl = []
        for c in range(STEPS):
            bstate, m = bstep(bstate, _tbatch(_batch(tmodel.cfg.vocab,
                                                     seed=100 + c)))
            bl.append(float(m["loss"]))
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(bl, jl_, **TRAJ_LOSS_TOL)
        with pytest.raises(AssertionError):
            _close_state(dict(bstate, ef=tstate["ef"]), _np(jstate), params,
                         flips=True)


def test_trajectory_ssm_with_full_remat_matches_reference():
    """The ssm family through the train step, with remat=full."""
    jmodel, tmodel = _models("mamba2_780m")
    params = _params(jmodel)
    jinit, jstep, tinit, tstep = _step_fns(jmodel, tmodel, "adafactor", 1,
                                           False, remat="full")
    jstate, tstate = jinit(params), tinit(params_from_numpy(params, "cpu"))
    jstate, tstate, jl_, tl_ = _run(jstep, tstep, jstate, tstate,
                                    tmodel.cfg.vocab, range(STEPS))
    np.testing.assert_allclose(tl_, jl_, **TRAJ_LOSS_TOL)
    _close_tree(tstate["params"], _np(jstate["params"]), **TRAJ_PARAM_TOL)


def test_microbatches_must_divide_the_batch():
    """Both packages refuse microbatches=3 on a (4, 16) batch: the
    reference's reshape into (3, 1, 16) raises, the port a ValueError that
    names both numbers (it dropped the last row before). Two microbatches
    of the same 4 rows still match the reference."""
    jmodel, tmodel = _models("qwen3_4b")
    params = _params(jmodel)
    batch = _batch(tmodel.cfg.vocab, b=4, s=16)
    jinit, jstep, tinit, tstep = _step_fns(jmodel, tmodel, "adamw", 3,
                                           False)
    with pytest.raises(TypeError, match="cannot reshape"):
        jstep(jinit(params), batch)
    with pytest.raises(ValueError, match="microbatches=3 .*batch size 4"):
        tstep(tinit(params_from_numpy(params, "cpu")), _tbatch(batch))
    jinit, jstep, tinit, tstep = _step_fns(jmodel, tmodel, "adamw", 2,
                                           False)
    _, jm = jstep(jinit(params), batch)
    _, tm = tstep(tinit(params_from_numpy(params, "cpu")), _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **TRAJ_LOSS_TOL)


# ---------------------------------------------------------------------------
# checkpoint cross-restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_checkpoint_cross_restore(saver, tmp_path):
    """Three steps on both sides; one side saves its state, the other
    restores it (into its own state's structure) and both continue three
    steps: the continued trajectories equal each other, and the restored
    state equals the saved one to the bit."""
    jmodel, tmodel = _models("qwen3_4b")
    params = _params(jmodel)
    jinit, jstep, tinit, tstep = _step_fns(jmodel, tmodel, "adafactor", 1,
                                           False)
    jstate, tstate = jinit(params), tinit(params_from_numpy(params, "cpu"))
    jstate, tstate, _, _ = _run(jstep, tstep, jstate, tstate,
                                tmodel.cfg.vocab, range(3))
    if saver == "jax":
        JaxCheckpointStore(str(tmp_path)).save(3, jstate, log_position=7,
                                               data_cursor=3)
        tstate, man = CheckpointStore(str(tmp_path)).restore(3, tstate)
        _close_tree(tstate, _np(jstate), rtol=0, atol=0)
    else:
        CheckpointStore(str(tmp_path)).save(3, tstate, log_position=7,
                                            data_cursor=3)
        saved = params_to_numpy(tstate)
        jstate, man = JaxCheckpointStore(str(tmp_path)).restore(3, jstate)
        _close_tree(saved, _np(jstate), rtol=0, atol=0)
        assert jstate["opt"]["step"].dtype == np.int32
    assert man["step"] == 3 and man["data_cursor"] == 3 \
        and man["log_position"] == 7
    assert int(tstate["opt"]["step"]) == 3
    assert tstate["opt"]["step"].dtype == torch.int32
    # both continue from the same state
    jstate, tstate, jl_, tl_ = _run(jstep, tstep, jstate, tstate,
                                    tmodel.cfg.vocab, range(3, 6))
    np.testing.assert_allclose(tl_, jl_, **TRAJ_LOSS_TOL)
    _close_state(tstate, _np(jstate), params)


def test_checkpoint_keys_are_the_reference_paths(tmp_path):
    """The npz holds the reference's ``/``-joined key paths, each store
    verifies a checkpoint the other wrote (same digest rule), and a state
    with error-feedback buffers restores across to the bit."""
    jmodel, tmodel = _models("mamba2_780m")
    params = _params(jmodel)
    jinit, _, tinit, _ = _step_fns(jmodel, tmodel, "adafactor", 1, True)
    CheckpointStore(str(tmp_path / "t")).save(
        0, tinit(params_from_numpy(params, "cpu")), log_position=0,
        data_cursor=0)
    JaxCheckpointStore(str(tmp_path / "j")).save(0, jinit(params),
                                                 log_position=0,
                                                 data_cursor=0)
    keys = [set(np.load(tmp_path / side / "step-0000000000" / "state.npz"))
            for side in ("t", "j")]
    assert keys[0] == keys[1]
    assert {"params/layers/mamba/w_in", "opt/v/embed/vr", "opt/step",
            "ef/final_norm"} <= keys[0]
    assert CheckpointStore(str(tmp_path / "j")).verify(0)
    assert JaxCheckpointStore(str(tmp_path / "t")).verify(0)
    like = tinit(init_params(smoke(get_config("mamba2_780m")),
                             torch.Generator().manual_seed(1), "cpu"))
    restored, _ = CheckpointStore(str(tmp_path / "j")).restore(0, like)
    _close_tree(restored, _np(jinit(params)), rtol=0, atol=0)


def test_dataclass_fields_match_reference():
    """The configs carry the reference's fields and defaults."""
    for t, j in ((OptimizerConfig, JaxOptimizerConfig),
                 (train_step.StepConfig, jax_train_step.StepConfig),
                 (pipeline.DataConfig, jax_pipeline.DataConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
            [(f.name, f.default) for f in dataclasses.fields(j)]
