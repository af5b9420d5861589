"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's, on the CPU, where ``flash_mha`` takes its plain
version: the Pallas ``ops.flash_mha`` in interpret mode (as the
reference's own tests run it) and its oracle ``ref.mha_ref``.

Inputs are unit-normal, made with numpy from a seed and handed to both
sides. Tolerance atol = rtol = 2e-5, the reference's own for its fp32 flash
kernel against ``mha_ref`` (``tests/test_kernels.py:49-71``).

One case is held to ``mha_ref`` alone: not causal with Sk not a multiple of
the Pallas block (128). There the Pallas kernel lets its zero pad keys into
the softmax (``flash_attention.py:41-45`` masks only by the causal and
window terms); the port masks every key at index >= Sk, as ``mha_ref`` and
the model's ``attention_ref`` do.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _check, flash_mha, flash_mha_plain)

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5, equal_nan=False)


def _args(seed, b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


def _mha_ref(q, k, v, **kw):
    """``ref.mha_ref`` on the model's layout (the reference's ``_ref_of``)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    fold = [jnp.asarray(t).transpose(0, 2, 1, 3).reshape(-1, t.shape[1], dh)
            for t in (q, k, v)]
    o = jax_ref.mha_ref(*fold, **kw)
    return np.asarray(o.reshape(b, h, sq, dh).transpose(0, 2, 1, 3))


def _port(q, k, v, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = flash_mha.launches
    out = flash_mha(*t, **kw)
    assert flash_mha.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(out.numpy(),
                                  flash_mha_plain(*t, **kw).numpy())
    return out.numpy()


@pytest.mark.parametrize("shape,kw", [
    # (B, Sq, Sk, H, Kv, Dh): the reference's flash sweep, fp32 ...
    ((1, 128, 128, 2, 2, 64), dict(causal=True)),
    ((2, 256, 256, 4, 2, 128), dict(causal=True)),
    ((1, 128, 384, 4, 1, 128), dict(causal=True)),
    ((1, 200, 200, 2, 2, 80), dict(causal=True)),
    # ... and its variants
    ((2, 256, 256, 4, 2, 128), dict(causal=False)),
    ((2, 256, 256, 4, 2, 128), dict(causal=True, window=64)),
    ((2, 256, 256, 4, 2, 128), dict(causal=True, softcap=50.0)),
    ((2, 256, 256, 4, 2, 128), dict(causal=True, window=128, softcap=30.0)),
    # head_dim 256 (gemma2_9b's), with gemma2's softcap and a window
    ((1, 256, 256, 2, 1, 256), dict(causal=True, window=100, softcap=50.0)),
], ids=["mha", "gqa", "mqa_sk_gt_sq", "unaligned", "noncausal", "window",
        "softcap", "window_softcap", "head_dim_256_window_softcap"])
def test_matches_pallas_kernel_and_oracle(shape, kw):
    q, k, v = _args(0, *shape)
    got = _port(q, k, v, **kw)
    pallas = jax_ops.flash_mha(*(jnp.asarray(t) for t in (q, k, v)),
                               interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, _mha_ref(q, k, v, **kw), **TOL)


def test_noncausal_unaligned_follows_mha_ref_not_the_pallas_pad_keys():
    """The Pallas pad-key case, (B, Sq, Sk, H, Kv, Dh) = (1, 200, 200, 2, 2,
    64) not causal: the Pallas kernel's 56 zero pad keys enter its softmax,
    so it is off ``mha_ref`` by far more than the tolerance; the port
    agrees with ``mha_ref``."""
    q, k, v = _args(1, 1, 200, 200, 2, 2, 64)
    got = _port(q, k, v, causal=False)
    want = _mha_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(jax_ops.flash_mha(
        *(jnp.asarray(t) for t in (q, k, v)), causal=False, interpret=True))
    assert np.abs(pallas - want).max() > 1e-2


@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True),
                                dict(causal=False, window=50)],
                         ids=["noncausal", "causal", "window"])
def test_sq_greater_than_sk_matches_mha_ref(kw):
    """Index-based, top-left aligned masks when Sq != Sk, as ``mha_ref``.
    With the window, query rows q >= Sk - 1 + window (119..149 here) see no
    key: ``mha_ref`` gives NaN there, the port 0, as its kernel does."""
    q, k, v = _args(2, 2, 150, 70, 4, 2, 32)
    got = _port(q, k, v, **kw)
    want = _mha_ref(q, k, v, **kw)
    blind = np.zeros(150, bool)
    if "window" in kw:
        blind[70 - 1 + kw["window"]:] = True
    assert np.isnan(want[:, blind]).all() and np.isfinite(want[:, ~blind]).all()
    np.testing.assert_array_equal(got[:, blind], 0.0)
    np.testing.assert_allclose(got[:, ~blind], want[:, ~blind], **TOL)


def test_inf_window_is_no_window():
    """The model passes INF_WINDOW (2**30) where a layer has no window."""
    q, k, v = (torch.from_numpy(a) for a in _args(3, 2, 40, 40, 4, 2, 16))
    np.testing.assert_array_equal(flash_mha(q, k, v, window=1 << 30).numpy(),
                                  flash_mha(q, k, v).numpy())


def test_kernel_limits_take_head_dim_256_not_264():
    """The kernel pads head dims to 64, 128 or 256, as the reference pads
    to a multiple of 128: 256 (gemma2_9b's) is taken, 264 refused."""
    def qkv(dh):
        return (torch.zeros((1, 4, 2, dh)), torch.zeros((1, 4, 1, dh)),
                torch.zeros((1, 4, 1, dh)))
    _check(*qkv(256), None, 50.0)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        _check(*qkv(264), None, None)


def test_a_device_without_a_kernel_raises():
    """CPU tensors take the plain version, CUDA ones the kernel, and meta
    ones (the dry-run's trace) come back as a meta output of q's shape;
    any other device raises. No such device exists here, so a stand-in
    carries one."""
    q, k, v = (torch.empty((1, 4, 2, 8), device="meta") for _ in range(3))
    assert flash_mha(q, k, v).shape == q.shape

    class OnXpu:
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="no kernel for xpu"):
        flash_mha(OnXpu(), OnXpu(), OnXpu())
