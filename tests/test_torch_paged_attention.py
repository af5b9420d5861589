"""Parity of the port's paged decode attention with the reference.

``paged_attention_plain`` (the plain PyTorch version that CPU tensors take)
is held against the reference's Pallas kernel run in interpret mode and
against its ``paged_attention_ref`` oracle, at the reference tests' shapes:
GQA ratios, ragged lengths including 0 and page boundaries, and a
softcap + scale case. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerance: atol = rtol = 2e-5, the reference's own kernel-vs-oracle
tolerance: fp32 on both sides, the online softmax (Pallas) and the
one-shot softmax sum in another order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    _check as kernel_check, _split_plan, paged_attention,
    paged_attention_plain)

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _paged_case(rng, s_n, h, kv, dh, page, n_pages_pool, ctx_lens):
    """Random pool + block tables realizing the given context lengths, as
    numpy arrays (disjoint shuffled pages per sequence; page 0 = pad)."""
    k_pages = rng.standard_normal((n_pages_pool, page, kv, dh)).astype(
        np.float32)
    v_pages = rng.standard_normal((n_pages_pool, page, kv, dh)).astype(
        np.float32)
    q = rng.standard_normal((s_n, h, dh)).astype(np.float32)
    max_pages = -(-max(max(ctx_lens), 1) // page)
    avail = list(rng.permutation(np.arange(1, n_pages_pool)))
    bt = np.zeros((s_n, max_pages), np.int32)
    for i, cl in enumerate(ctx_lens):
        for j in range(-(-cl // page)):
            bt[i, j] = avail.pop()
    return q, k_pages, v_pages, bt, np.asarray(ctx_lens, np.int32)


def _check(case, **kw):
    tout = paged_attention_plain(*(torch.from_numpy(a) for a in case), **kw)
    jcase = [jnp.asarray(a) for a in case]
    np.testing.assert_allclose(tout.numpy(),
                               np.asarray(paged_attention_ref(*jcase, **kw)),
                               **TOL)
    np.testing.assert_allclose(
        tout.numpy(), np.asarray(jax_paged(*jcase, interpret=True, **kw)),
        **TOL)
    return tout


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])  # GQA ratios
def test_plain_parity_gqa(h, kv):
    rng = np.random.default_rng(0)
    _check(_paged_case(rng, s_n=3, h=h, kv=kv, dh=32, page=8,
                       n_pages_pool=16, ctx_lens=[5, 16, 23]))


def test_plain_parity_ragged_and_boundaries():
    """Sub-page, exact page boundary, boundary+1, and an inactive lane."""
    rng = np.random.default_rng(1)
    out = _check(_paged_case(rng, s_n=5, h=4, kv=2, dh=16, page=8,
                             n_pages_pool=24, ctx_lens=[1, 7, 8, 17, 0]))
    assert torch.all(out[4] == 0.0)  # inactive lane -> exact zeros


def test_plain_parity_softcap_and_scale():
    rng = np.random.default_rng(2)
    _check(_paged_case(rng, s_n=2, h=4, kv=2, dh=16, page=4,
                       n_pages_pool=12, ctx_lens=[6, 11]),
           softcap=30.0, scale=0.25)


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(3)
    case = [torch.from_numpy(a) for a in _paged_case(
        rng, s_n=3, h=4, kv=2, dh=16, page=4, n_pages_pool=12,
        ctx_lens=[3, 0, 9])]
    before = paged_attention.launches
    out = paged_attention(*case, softcap=30.0)
    assert torch.equal(out, paged_attention_plain(*case, softcap=30.0))
    assert paged_attention.launches == before  # no kernel launched


def test_wrapper_has_no_fallback_off_the_cpu():
    """Only CPU tensors take the plain version: a tensor elsewhere gets
    the kernel or an error, never a silent plain run."""
    rng = np.random.default_rng(4)
    case = [torch.from_numpy(a).to("meta") for a in _paged_case(
        rng, s_n=2, h=4, kv=2, dh=16, page=4, n_pages_pool=8,
        ctx_lens=[3, 5])]
    with pytest.raises(ValueError):
        paged_attention(*case)


def test_kernel_takes_any_page_size():
    """The kernel gathers K/V one key row at a time, so a page of 256 keys
    at head_dim 128 (a tile of pages x head_dim over 16384, which the
    kernel once refused) is taken; head_dim % 4 != 0 or above 256 is not."""
    def case(page, dh):
        z = torch.zeros
        return (z(2, 8, dh), z(3, page, 2, dh), z(3, page, 2, dh),
                z(2, 2, dtype=torch.int32), z(2, dtype=torch.int32))
    kernel_check(*case(256, 128), None)
    kernel_check(*case(64, 256), None)
    for dh in (30, 260):
        with pytest.raises(ValueError, match="head_dim"):
            kernel_check(*case(16, dh), None)


def test_split_plan_from_shapes():
    """The split is chosen from shapes and the SM count only. At the main
    path's decode step (4 lanes, 8 kv heads of 4 query heads, 64 pages of
    16 keys, an H100's 132 SMs) every 32-key tile gets its own block; more
    lanes get longer chunks; the chunks always cover the table."""
    assert _split_plan(4, 8, 4, 64 * 16, 132) == (4, 32, 32)
    assert _split_plan(8, 8, 4, 128 * 16, 132) == (4, 64, 32)
    hb, chunk, n_splits = _split_plan(24, 8, 4, 128 * 16, 132)
    assert (hb, chunk % 32) == (4, 0) and chunk > 64
    assert chunk * n_splits >= 128 * 16 > chunk * (n_splits - 1)
    assert _split_plan(1, 1, 40, 100, 132)[0] == 14  # 40 heads: 14, 14, 12
    assert _split_plan(2, 1, 1, 1, 132) == (1, 32, 1)
