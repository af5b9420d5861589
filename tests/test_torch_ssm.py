"""The port's Mamba2 SSD path against the reference's, on the CPU: the
intra-chunk terms (``kernels.ssd_scan``; CPU tensors take the plain
version), the chunked scan, the decode recurrence, the convolutions, the
block and the ssm ``Model`` (prefill, decode, caches, parameter tree).

Inputs are made with numpy from a seed and handed to both sides. The
Pallas kernel runs in interpret mode, as the reference's own tests run it.
Tolerances are the reference's own for the same comparison:
1e-4 for the intra-chunk terms against the Pallas kernel and its oracle
(``tests/test_kernels.py:104-109``), 5e-4 for the chunked output and 5e-3
for its final state (``:85-90``), 2e-4 for model logits
(``tests/test_models.py:84-86``). Both sides are fp32 and sum in another
order, so equality to the last bit is not expected.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke as jax_smoke  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra as jax_ssd_intra  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.params import split_params  # noqa: E402
from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.kernels.ssd_scan import (_block_plan,  # noqa: E402
                                          _check, ssd_intra,
                                          ssd_intra_plain)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_numpy)

torch.set_num_threads(1)
INTRA_TOL = dict(rtol=1e-4, atol=1e-4)
Y_TOL = dict(rtol=5e-4, atol=5e-4)
STATE_TOL = dict(rtol=5e-3, atol=5e-3)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _ssd_inputs(seed, b, s, h, p, g, n, *, a=None, dt_shift=0.0):
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n), D (h,): the
    distributions of the reference's SSD tests."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(f)
    dt = _softplus(rng.standard_normal((b, s, h)) + dt_shift)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f) if a is None \
        else np.full(h, a, f)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(f)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(f)
    D = np.full(h, 0.5, f)
    return x, dt, A, B, C, D


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# intra-chunk terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # (b, nc, q, h, p, n, head_block)
    (1, 3, 16, 4, 8, 16, 2),      # tests/test_kernels.py's oracle case
    (2, 2, 32, 8, 16, 32, 8),
    (1, 1, 64, 2, 64, 64, 2),
    (1, 2, 32, 2, 96, 16, 2),     # head dims past the kernel's 64-column
    (1, 1, 64, 2, 128, 32, 1),    # blocks (the Pallas kernel takes any)
], ids=["oracle-case", "b2", "q64", "p96", "p128"])
def test_ssd_intra_plain_matches_pallas_and_oracle(shape):
    b, nc, q, h, p, n, hb = shape
    x, dt, A, B, C, _ = _ssd_inputs(1, b, nc * q, h, p, h, n)
    x = x.reshape(b, nc, q, h, p)
    dt = dt.reshape(b, nc, q, h)
    B = B.reshape(b, nc, q, h, n)
    C = C.reshape(b, nc, q, h, n)
    got = ssd_intra_plain(*_t(x, dt, A, B, C))
    pallas = jax_ssd_intra(*_j(x, dt, A, B, C), head_block=hb,
                           interpret=True)
    oracle = jax_ref.ssd_intra_ref(*_j(x, dt, A, B, C))
    for g_, p_, o_ in zip(got, pallas, oracle):
        assert tuple(g_.shape) == p_.shape and g_.dtype == torch.float32
        _close(g_, p_, **INTRA_TOL)
        _close(g_, o_, **INTRA_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_intra_groups_equal_repeated_heads(g):
    """B/C per group (G < H): the same as the reference's signature on B/C
    repeated over the heads (head h reads group h // (H/G))."""
    b, nc, q, h, p, n = 2, 2, 16, 8, 8, 16
    x, dt, A, B, C, _ = _ssd_inputs(2, b, nc * q, h, p, g, n)
    x = x.reshape(b, nc, q, h, p)
    dt = dt.reshape(b, nc, q, h)
    B = B.reshape(b, nc, q, g, n)
    C = C.reshape(b, nc, q, g, n)
    Bh, Ch = (np.repeat(t, h // g, axis=3) for t in (B, C))
    got = ssd_intra_plain(*_t(x, dt, A, B, C))
    pallas = jax_ssd_intra(*_j(x, dt, A, Bh, Ch), head_block=4,
                           interpret=True)
    oracle = jax_ref.ssd_intra_ref(*_j(x, dt, A, Bh, Ch))
    for g_, p_, o_ in zip(got, pallas, oracle):
        _close(g_, p_, **INTRA_TOL)
        _close(g_, o_, **INTRA_TOL)


def test_ssd_intra_wrapper_takes_plain_on_cpu():
    x, dt, A, B, C, _ = _ssd_inputs(3, 1, 32, 4, 8, 2, 16)
    args = _t(x.reshape(1, 2, 16, 4, 8), dt.reshape(1, 2, 16, 4), A,
              B.reshape(1, 2, 16, 2, 16), C.reshape(1, 2, 16, 2, 16))
    before = ssd_intra.launches
    got = ssd_intra(*args)
    assert ssd_intra.launches == before  # no kernel on the CPU
    for g_, w_ in zip(got, ssd_intra_plain(*args)):
        assert torch.equal(g_, w_)


def test_ssd_block_plan_from_shapes():
    """How the kernel cuts the work, from shapes alone. At the main path's
    prefill (4 rows x 3 chunks of 256, 48 heads of one group, an H100's
    132 SMs) a y-block serves 8 heads and every query-tile level runs
    before the state blocks; longer chunks take fewer heads a block (their
    cs arrays fill shared memory), and small grids halve the head block."""
    assert _block_plan(12, 256, 48, 1, 64, 128, 132) == (8, 4)
    assert _block_plan(16, 256, 44, 1, 64, 128, 132) == (8, 4)  # 8 x 5 + 4
    assert _block_plan(8, 1024, 24, 1, 64, 128, 132)[0] == 3
    assert _block_plan(1, 4096, 48, 1, 64, 128, 132)[0] == 1
    assert _block_plan(6, 256, 48, 1, 64, 128, 132)[0] == 4
    assert _block_plan(1, 64, 2, 2, 64, 64, 132)[0] == 1
    hb, top = _block_plan(12, 256, 48, 1, 64, 256, 132)
    assert hb == 8 and 0 < top < 4  # a heavy state block goes earlier


@pytest.mark.parametrize("p", [96, 128, 130])
def test_ssd_wrapper_takes_any_head_dim(p):
    """The wrapper's checks pass any head dim (an earlier kernel refused
    P > 64 with a ValueError); the plan cuts P into 64-column blocks, so
    its head block and levels are those of one 64-column block with the
    grid ceil(P / 64) times larger."""
    x, dt, A, B, C, _ = _ssd_inputs(6, 1, 32, 4, p, 2, 16)
    _check(*_t(x.reshape(1, 2, 16, 4, p), dt.reshape(1, 2, 16, 4), A,
               B.reshape(1, 2, 16, 2, 16), C.reshape(1, 2, 16, 2, 16)))
    assert _block_plan(12, 256, 48, 1, p, 128, 132) == (8, 4)
    # 40 chunks of one query tile, 2 groups of 4 heads: at hb = 2 the
    # y-blocks are 160 at P = 64, under two an SM, so hb halves to 1; at
    # P > 64 they are 320 or 480, and hb stays 2
    assert _block_plan(40, 64, 8, 2, 64, 64, 132)[0] == 1
    assert _block_plan(40, 64, 8, 2, p, 64, 132)[0] == 2


def test_ssd_intra_overflow_upper_triangle_is_zero():
    """Chunk 256 at A = -1 and dt ~ 1: exp(cs_t - cs_u) above the diagonal
    is inf in fp32; the terms there must be exactly 0, not NaN."""
    b, q, h, p, n = 1, 256, 2, 8, 16
    x, dt, A, B, C, _ = _ssd_inputs(4, b, q, h, p, h, n, a=-1.0,
                                    dt_shift=0.5)
    cs = np.cumsum(dt[0, :, 0] * A[0])
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(cs[0] - cs[-1]))  # the overflow is real
    args = (x.reshape(b, 1, q, h, p), dt.reshape(b, 1, q, h), A,
            B.reshape(b, 1, q, h, n), C.reshape(b, 1, q, h, n))
    got = ssd_intra_plain(*_t(*args))
    oracle = jax_ref.ssd_intra_ref(*_j(*args))
    for g_, o_ in zip(got, oracle):
        assert torch.isfinite(g_).all()
        _close(g_, o_, **INTRA_TOL)


# ---------------------------------------------------------------------------
# chunked scan, recurrence, decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # (b, s, h, p, g, n, chunk, head_block): tests/test_kernels.py:66-71
    (1, 64, 4, 16, 1, 32, 16, 4),
    (2, 128, 8, 32, 2, 16, 32, 8),
    (1, 96, 4, 64, 1, 64, 32, 2),   # s not a chunk multiple (pad path)
    (2, 45, 4, 8, 2, 16, 16, 4),    # ragged tail, G < H
], ids=["s64", "s128-g2", "s96-pad", "s45-pad-g2"])
def test_ssd_chunked_matches_reference(shape):
    b, s, h, p, g, n, chunk, hb = shape
    x, dt, A, B, C, D = _ssd_inputs(5, b, s, h, p, g, n)
    wants = (jax_ssm.ssd_chunked(*_j(x, dt, A, B, C, D), chunk=chunk),
             jax_ops.ssd_chunked_pallas(*_j(x, dt, A, B, C, D), chunk=chunk,
                                        head_block=hb, interpret=True),
             jax_ssm.ssd_ref(*_j(x, dt, A, B, C, D)))
    for use_kernel in (True, False):  # CPU tensors: both take the plain
        y, st = ssm.ssd_chunked(*_t(x, dt, A, B, C, D), chunk=chunk,
                                use_kernel=use_kernel)
        for want_y, want_st in wants:
            _close(y, want_y, **Y_TOL)
            _close(st, want_st, **STATE_TOL)


def test_ssd_chunked_with_init_state_matches_reference():
    b, s, h, p, g, n = 2, 40, 4, 8, 1, 16
    x, dt, A, B, C, D = _ssd_inputs(6, b, s, h, p, g, n)
    s0 = (np.random.default_rng(7).standard_normal((b, h, p, n)) * 0.3
          ).astype(np.float32)
    y, st = ssm.ssd_chunked(*_t(x, dt, A, B, C, D), init_state=_t(s0)[0],
                            chunk=16)
    jy, jst = jax_ssm.ssd_chunked(*_j(x, dt, A, B, C, D),
                                  init_state=jnp.asarray(s0), chunk=16)
    _close(y, jy, **Y_TOL)
    _close(st, jst, **STATE_TOL)
    ry, rst = ssm.ssd_ref(*_t(x, dt, A, B, C, D), init_state=_t(s0)[0])
    jry, jrst = jax_ssm.ssd_ref(*_j(x, dt, A, B, C, D),
                                init_state=jnp.asarray(s0))
    _close(ry, jry, **Y_TOL)
    _close(rst, jrst, **STATE_TOL)


def test_ssd_chunked_overflow_case_finite_and_equal():
    """Chunk 256, A = -1, dt ~ 1 over two chunks (one padded): finite
    outputs equal to the reference's."""
    b, s, h, p, g, n = 1, 300, 2, 8, 1, 16
    x, dt, A, B, C, D = _ssd_inputs(8, b, s, h, p, g, n, a=-1.0,
                                    dt_shift=0.5)
    y, st = ssm.ssd_chunked(*_t(x, dt, A, B, C, D), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jy, jst = jax_ssm.ssd_chunked(*_j(x, dt, A, B, C, D), chunk=256)
    _close(y, jy, **Y_TOL)
    _close(st, jst, **STATE_TOL)


def test_ssd_decode_steps_match_reference_and_prefill_state():
    b, s, h, p, g, n = 1, 12, 4, 8, 2, 8
    x, dt, A, B, C, D = _ssd_inputs(9, b, s, h, p, g, n)
    tx, tdt, tA, tB, tC, tD = _t(x, dt, A, B, C, D)
    state = torch.zeros((b, h, p, n))
    jstate = jnp.zeros((b, h, p, n), jnp.float32)
    for t in range(s):
        y, state = ssm.ssd_decode_step(state, tx[:, t], tdt[:, t], tA,
                                       tB[:, t], tC[:, t], tD)
        jy, jstate = jax_ssm.ssd_decode_step(
            jstate, *_j(x[:, t], dt[:, t], A, B[:, t], C[:, t], D))
        _close(y, jy, **Y_TOL)
    _close(state, jstate, **STATE_TOL)
    _, st_full = ssm.ssd_chunked(tx, tdt, tA, tB, tC, None, chunk=4)
    _close(state, st_full, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# convolutions and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_state", [(7, False), (7, True), (2, True)],
                         ids=["s7", "s7-state", "s2-state"])
def test_causal_conv1d_matches_reference(s, with_state):
    rng = np.random.default_rng(10)
    u = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = (rng.standard_normal((12, 4)) * 0.5).astype(np.float32)
    st = rng.standard_normal((2, 12, 3)).astype(np.float32) \
        if with_state else None
    y, new = ssm.causal_conv1d(*_t(u, w), None if st is None else _t(st)[0])
    jy, jnew = jax_ssm.causal_conv1d(jnp.asarray(u), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    _close(y, jy, rtol=1e-5, atol=1e-5)
    _close(new, jnew, rtol=0, atol=0)


def test_conv_step_matches_reference_and_causal_conv1d():
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, 6, 12)).astype(np.float32)
    w = (rng.standard_normal((12, 4)) * 0.5).astype(np.float32)
    tu, tw = _t(u, w)
    st, jst = torch.zeros((2, 12, 3)), jnp.zeros((2, 12, 3), jnp.float32)
    ys = []
    for t in range(6):
        y, st = ssm._conv_step(tu[:, t], tw, st)
        jy, jst = jax_ssm._conv_step(jnp.asarray(u[:, t]), jnp.asarray(w),
                                     jst)
        _close(y, jy, rtol=1e-5, atol=1e-5)
        _close(st, jst, rtol=0, atol=0)
        ys.append(y)
    full, fst = ssm.causal_conv1d(tu, tw)
    _close(torch.stack(ys, 1), full, rtol=1e-5, atol=1e-5)
    assert torch.equal(st, fst)


@pytest.fixture(scope="module")
def mamba():
    """smoke(mamba2_780m) on both sides, the reference's parameters carried
    over losslessly."""
    jcfg = jax_smoke(jax_get_config("mamba2_780m"))
    tcfg = smoke(get_config("mamba2_780m"))
    jparams, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("s", [5, 16, 37], ids=["s5", "s16", "s37"])
def test_mamba2_block_prefill_and_decode_match_reference(mamba, s):
    jcfg, tcfg, jparams, tparams = mamba
    jlp = _layer0(jparams["layers"]["mamba"])
    tlp = {k: v[0] for k, v in tparams["layers"]["mamba"].items()}
    x = np.random.default_rng(12 + s).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    y, (st, cv) = ssm.mamba2_block(_t(x)[0], tlp, tcfg)
    jy, (jst, jcv) = jax_ssm.mamba2_block(jnp.asarray(x), jlp, jcfg)
    _close(y, jy, **Y_TOL)
    _close(st, jst, **STATE_TOL)
    _close(cv, jcv, rtol=1e-5, atol=1e-5)
    x1 = np.random.default_rng(99).standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32)
    y1, (st1, cv1) = ssm.mamba2_block(_t(x1)[0], tlp, tcfg, ssm_state=st,
                                      conv_state=cv, decode=True)
    jy1, (jst1, jcv1) = jax_ssm.mamba2_block(
        jnp.asarray(x1), jlp, jcfg, ssm_state=jst, conv_state=jcv,
        decode=True)
    _close(y1, jy1, **Y_TOL)
    _close(st1, jst1, **STATE_TOL)
    _close(cv1, jcv1, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the ssm Model: parameter tree, caches, prefill, decode
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_ssm_param_tree_matches_reference(mamba):
    jcfg, tcfg, jparams, _ = mamba
    want = {k: np.asarray(v) for k, v in _flat(jparams).items()}
    got = _flat(init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert got.keys() == want.keys()
    assert "/layers/ln1" in got and "/layers/ln2" not in got
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert t.dtype == torch.float32, path
        name = path.rsplit("/", 1)[-1]
        if name in ("A_log", "dt_bias", "norm", "ln1", "final_norm", "D"):
            # constants: A_log = log 1, dt_bias and norms 0, D = 1
            assert torch.equal(t, torch.tensor(want[path])), path
            continue
        scale = {"embed": 1.0, "conv_w": 0.5}.get(
            name, 1.0 / np.sqrt(t.shape[-2]))
        assert abs(t.std().item() / scale - 1.0) < 0.1, (path, t.std())


def test_full_width_config_counts():
    cfg = get_config("mamba2_780m")
    assert cfg.n_params() == jax_get_config("mamba2_780m").n_params() \
        == 779_911_680
    assert Model(cfg).vocab_pad == 50432
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.d_state, cfg.ssm.head_dim,
            cfg.ssm.chunk) == (48, 1536, 128, 64, 256)


def test_init_cache_matches_reference(mamba):
    jcfg, tcfg, _, _ = mamba
    jc, _ = split_params(JaxModel(jcfg, dtype=jnp.float32).init_cache(3, 20))
    tc = Model(tcfg).init_cache(3, 20, device="cpu")
    jflat, tflat = _flat(jc), _flat(tc)
    assert tflat.keys() == jflat.keys() == {"/ssm/state", "/ssm/conv"}
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape
        assert not tflat[k].any()


def test_model_prefill_and_decode_match_reference(mamba):
    jcfg, tcfg, jparams, tparams = mamba
    jm, tm = JaxModel(jcfg, dtype=jnp.float32), Model(tcfg)
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (2, 21))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == jl.shape == (2, 1, tm.vocab_pad)
    _close(tl, jl, **LOGIT_TOL)
    assert torch.all(tl[..., tcfg.vocab:] == -1e30)
    _close(tc["ssm"]["state"], jc["ssm"]["state"], **STATE_TOL)
    _close(tc["ssm"]["conv"], jc["ssm"]["conv"], rtol=1e-4, atol=1e-4)
    tok = np.array([[3], [77]])
    for step in range(3):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(21 + step))
        tl, tc2 = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                 21 + step)
        assert tc2 is not tc and tc2["ssm"]["state"] is not \
            tc["ssm"]["state"]
        tc = tc2
        _close(tl, jl, **LOGIT_TOL)
        _close(tc["ssm"]["state"], jc["ssm"]["state"], **STATE_TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]


def test_prefill_decode_consistency(mamba):
    """Greedy decode from an empty cache over S+1 tokens equals the
    teacher-forced prefill's last logits (the reference's
    test_prefill_decode_consistency, on the port)."""
    _, tcfg, _, tparams = mamba
    model = Model(tcfg)
    toks = torch.from_numpy(
        np.random.default_rng(14).integers(0, tcfg.vocab, (1, 13)))
    full_logits, _ = model.prefill(tparams, {"tokens": toks})
    cache = model.init_cache(1, 13, device="cpu")
    for t in range(13):
        logits, cache = model.decode_step(tparams, cache, toks[:, t:t + 1], t)
    _close(logits[:, 0], full_logits[:, -1], **LOGIT_TOL)


def test_other_families_raise_naming_the_family():
    # every family of the reference is ported (test_torch_dense_static,
    # test_torch_moe, test_torch_hybrid, test_torch_encdec_vlm); an
    # unknown one raises ValueError naming it, as the reference's does
    model = Model(dataclasses.replace(smoke(get_config("qwen3_4b")),
                                      family="bogus"))
    for call in (lambda: model.init_cache(1, 4, device="cpu"),
                 lambda: model.prefill({}, {"tokens": None}),
                 lambda: model.decode_step({}, {}, None, 0)):
        with pytest.raises(ValueError, match="bogus"):
            call()
