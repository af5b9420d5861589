"""Tests of the port that need the card: each CUDA kernel (paged
attention, the SSD intra-chunk terms, flash attention) against its plain
version, the tokens of the paths they carry (the paged engine, static
mamba2, qwen3, gemma2, mixtral, zamba2, whisper and internvl2 serving)
with the kernel against the plain path, one full-width mixtral moe layer on the card against the
CPU, and the train step on the card against the same step on the CPU,
whose loss and backward launch no kernel. Marked ``cuda``; they skip where there is
no card. Run them on a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

This file imports no JAX: the machine with the card need not have it.

Tolerance for paged attention vs plain: atol = rtol = 2e-5 on
unit-normal inputs, the reference's own kernel-vs-oracle tolerance; both
are fp32 and sum in another order (online softmax over pages vs one
softmax over the gather). For the SSD kernel: atol = rtol = 1e-4, the
reference's tolerance for its SSD kernel against the oracle
(``tests/test_kernels.py:104-109``); the kernel's cumsum is a parallel
scan, the plain one another order. For flash attention: atol = rtol =
2e-5 on unit-normal inputs, the reference's tolerance for its flash kernel
against ``mha_ref`` (``tests/test_kernels.py:64-71``); an online softmax
over key tiles against one softmax. For the train step, card vs CPU:
losses and grad norms rtol 1e-5 (fp32 on both, sums in another order);
each parameter leaf's distance from the CPU's within 1e-3 of the CPU's
update of that leaf (``chip_smoke.py``'s ``UPDATE_RTOL``: AdamW's first
update is near sign(g), so an entry whose gradient is near ``eps`` moves
by a sizeable part of lr on ulp-level gradient differences).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_config, smoke  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_mha, flash_mha_plain)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    _split_plan, paged_attention, paged_attention_plain)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    _block_plan, ssd_intra, ssd_intra_plain)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.serving import server  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402
from repro_torch.train.train_step import (StepConfig,  # noqa: E402
                                          make_train_step)

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, s_n, h, kv, dh, page, n_pages_pool, ctx_lens, device):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages_pool, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages_pool, page, kv, dh)).astype(np.float32)
    q = rng.standard_normal((s_n, h, dh)).astype(np.float32)
    max_pages = -(-max(max(ctx_lens), 1) // page)
    avail = list(rng.permutation(np.arange(1, n_pages_pool)))
    bt = np.zeros((s_n, max_pages), np.int32)
    for i, cl in enumerate(ctx_lens):
        for j in range(-(-cl // page)):
            bt[i, j] = avail.pop()
    cl = np.asarray(ctx_lens, np.int32)
    return [torch.from_numpy(a).to(device) for a in (q, kp, vp, bt, cl)]


@pytest.mark.parametrize("shape,kw", [
    (dict(s_n=3, h=4, kv=4, dh=32, page=8, n_pages_pool=16,
          ctx_lens=[5, 16, 23]), {}),
    (dict(s_n=3, h=4, kv=2, dh=32, page=8, n_pages_pool=16,
          ctx_lens=[5, 16, 23]), {}),
    (dict(s_n=3, h=8, kv=1, dh=32, page=8, n_pages_pool=16,
          ctx_lens=[5, 16, 23]), {}),
    (dict(s_n=5, h=4, kv=2, dh=16, page=8, n_pages_pool=24,
          ctx_lens=[1, 7, 8, 17, 0]), {}),
    (dict(s_n=2, h=4, kv=2, dh=16, page=4, n_pages_pool=12,
          ctx_lens=[6, 11]), dict(softcap=30.0, scale=0.25)),
    (dict(s_n=8, h=32, kv=8, dh=128, page=16, n_pages_pool=520,
          ctx_lens=[0, 1, 15, 16, 17, 300, 1000, 2047]), {}),
    (dict(s_n=4, h=8, kv=2, dh=64, page=12, n_pages_pool=64,
          ctx_lens=[11, 12, 61, 200]), {}),
    (dict(s_n=3, h=8, kv=4, dh=128, page=32, n_pages_pool=40,
          ctx_lens=[31, 33, 300]), {}),
    (dict(s_n=2, h=32, kv=8, dh=128, page=16, n_pages_pool=800,
          ctx_lens=[4096, 8191]), {}),
    (dict(s_n=7, h=32, kv=8, dh=128, page=16, n_pages_pool=64,
          ctx_lens=[31, 32, 33, 63, 64, 65, 0]), {}),
    (dict(s_n=3, h=32, kv=8, dh=128, page=256, n_pages_pool=12,
          ctx_lens=[255, 700, 257]), {}),
    (dict(s_n=3, h=16, kv=8, dh=256, page=64, n_pages_pool=24,
          ctx_lens=[64, 600, 129]), dict(softcap=50.0)),
    (dict(s_n=5, h=32, kv=8, dh=128, page=16, n_pages_pool=80,
          ctx_lens=[0, 300, 0, 17, 0]), {}),
    (dict(s_n=4, h=32, kv=2, dh=128, page=16, n_pages_pool=257,
          ctx_lens=[0, 17, 700, 1023]), {}),
    (dict(s_n=4, h=32, kv=32, dh=128, page=16, n_pages_pool=257,
          ctx_lens=[0, 17, 700, 1023]), {}),
], ids=["gqa4-4", "gqa4-2", "gqa8-1", "ragged", "softcap", "full_width",
        "page12", "page32", "many_splits", "split_edges", "page256",
        "page64_head_dim_256", "inactive_lanes", "chatglm3_rep16",
        "codeqwen_rep1"])
def test_kernel_matches_plain(cuda, shape, kw):
    case = _case(0, device=cuda, **shape)
    before = paged_attention.launches
    out = paged_attention(*case, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_plain(*case, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    zero = case[4] == 0
    assert torch.all(out[zero] == 0)  # inactive lanes: exact zeros


def test_kernel_split_edges_with_long_chunks(cuda):
    """With many lanes a block walks several 32-key tiles of its chunk
    (its size chosen from shapes by ``_split_plan``); contexts end just
    before, at and just after a chunk's edge."""
    _, chunk, n_splits = _split_plan(24, 8, 4, 128 * 16,
                                     cuda_lib.n_sm(cuda))
    assert chunk > 32 and n_splits > 1
    ctx = [chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 2047, 0] * 4
    case = _case(5, 24, 32, 8, 128, 16, 800, ctx, cuda)
    assert case[3].shape[1] == 128
    out = paged_attention(*case)
    ref = paged_attention_plain(*case)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert torch.all(out[case[4] == 0] == 0)


def test_kernel_is_deterministic(cuda):
    """The partials merge in split order: two calls give the same bits."""
    case = _case(6, 4, 32, 8, 128, 16, 400, [473, 149, 3000, 577], cuda)
    first = paged_attention(*case)
    assert all(torch.equal(first, paged_attention(*case)) for _ in range(3))


def test_kernel_rejects_what_it_does_not_take(cuda):
    case = _case(1, 2, 4, 2, 16, 4, 8, [3, 5], cuda)
    with pytest.raises(TypeError):
        paged_attention(case[0].double(), *case[1:])
    with pytest.raises(ValueError):
        paged_attention(case[0][:, ::2], *case[1:])  # head mismatch


def test_engine_tokens_kernel_vs_plain(cuda):
    cfg = smoke(get_config("qwen3_4b"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 100, size=n).tolist() for n in (5, 9, 13, 2)]
    outs, params = [], None
    for use_kernel in (True, False):
        eng = PagedEngine(cfg, max_batch=3, num_pages=32, page_size=8,
                          params=params, use_kernel=use_kernel, device=cuda)
        params = eng.params
        paged_attention.launches = 0
        queue, done = list(enumerate(prompts)), {}
        while queue or eng.n_inflight:
            if queue and eng.can_admit(len(queue[0][1]), 6):
                i, p = queue.pop(0)
                assert eng.admit(f"r{i}", p, 6)
            done.update((s.req_id, s.tokens) for s in eng.step())
        want = eng.n_steps * cfg.n_layers if use_kernel else 0
        assert paged_attention.launches == want
        outs.append(done)
    assert outs[0] == outs[1] and len(outs[0]) == 4


# ---------------------------------------------------------------------------
# SSD intra-chunk kernel
# ---------------------------------------------------------------------------

SSD_TOL = dict(atol=1e-4, rtol=1e-4)


def _ssd_case(seed, b, nc, q, h, p, g, n, device, a=None, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((b, nc, q, h, p)) * 0.5).astype(f)
    dt = np.logaddexp(rng.standard_normal((b, nc, q, h)) + dt_shift,
                      0.0).astype(f)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f) if a is None \
        else np.full(h, a, f)
    B = (rng.standard_normal((b, nc, q, g, n)) * 0.3).astype(f)
    C = (rng.standard_normal((b, nc, q, g, n)) * 0.3).astype(f)
    return [torch.from_numpy(t).to(device) for t in (x, dt, A, B, C)]


@pytest.mark.parametrize("shape,kw", [
    (dict(b=1, nc=3, q=16, h=4, p=8, g=4, n=16), {}),
    (dict(b=2, nc=2, q=32, h=8, p=16, g=8, n=32), {}),
    (dict(b=1, nc=1, q=64, h=2, p=64, g=2, n=64), {}),
    (dict(b=2, nc=2, q=32, h=8, p=8, g=2, n=16), {}),          # G < H
    (dict(b=1, nc=2, q=80, h=4, p=32, g=1, n=24), {}),         # ragged tile
    (dict(b=1, nc=2, q=256, h=4, p=64, g=1, n=128),
     dict(a=-1.0, dt_shift=0.5)),                              # overflow
    (dict(b=1, nc=1, q=300, h=2, p=16, g=1, n=32),
     dict(a=-1.0, dt_shift=0.5)),             # cumsum past 256 rows, carry
    (dict(b=2, nc=3, q=256, h=48, p=64, g=1, n=128),
     dict(a=-1.0)),                           # mamba2: 48 heads share C B^T
    (dict(b=2, nc=4, q=128, h=8, p=64, g=2, n=64), {}),  # 2 groups of 4
    (dict(b=2, nc=4, q=1024, h=24, p=64, g=1, n=128),
     dict(a=-1.0)),                           # groups of key tiles, RMW of y
    (dict(b=1, nc=2, q=96, h=6, p=20, g=3, n=36), {}),  # P, N not 32-wide
    (dict(b=1, nc=2, q=70, h=4, p=6, g=2, n=10), {}),   # 4-byte copies
    # head dims past the kernel's 64-column blocks (an earlier wrapper
    # refused them with a ValueError)
    (dict(b=2, nc=2, q=256, h=8, p=128, g=1, n=128), dict(a=-1.0)),
    (dict(b=1, nc=3, q=160, h=6, p=96, g=2, n=64), {}),
    (dict(b=1, nc=2, q=70, h=2, p=130, g=1, n=10), {}),  # 4-byte copies
    (dict(b=2, nc=3, q=256, h=64, p=64, g=1, n=64),
     dict(a=-1.0)),                           # zamba2's mamba layers
], ids=["oracle-case", "b2", "q64", "g2-of-8", "q80", "overflow", "q300",
        "reuse_h48_g1", "g2_of_8_q128", "q1024", "p20_n36", "p6_n10",
        "p128", "p96", "p130", "zamba2_h64_p64_n64"])
def test_ssd_kernel_matches_plain(cuda, shape, kw):
    case = _ssd_case(0, device=cuda, **shape, **kw)
    before = ssd_intra.launches
    out = ssd_intra(*case)
    torch.cuda.synchronize()
    assert ssd_intra.launches == before + 1
    for got, want in zip(out, ssd_intra_plain(*case)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **SSD_TOL)


def test_ssd_kernel_partial_head_block(cuda):
    """44 heads in blocks of 8: the last y-block of each chunk serves 4."""
    hb, _ = _block_plan(16, 256, 44, 1, 64, 128, cuda_lib.n_sm(cuda))
    assert hb > 1 and 44 % hb
    case = _ssd_case(2, 2, 8, 256, 44, 64, 1, 128, cuda, a=-1.0)
    for got, want in zip(ssd_intra(*case), ssd_intra_plain(*case)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **SSD_TOL)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, a, b, c = _ssd_case(1, 1, 1, 16, 4, 64, 2, 16, cuda)
    with pytest.raises(TypeError):
        ssd_intra(x.double(), dt, a, b, c)
    with pytest.raises(ValueError):  # 3 groups do not divide 4 heads
        ssd_intra(x, dt, a, torch.cat([b, b[..., :1, :]], 3),
                  torch.cat([c, c[..., :1, :]], 3))
    with pytest.raises(ValueError):  # not contiguous
        ssd_intra(x.transpose(3, 4).contiguous().transpose(3, 4), dt, a, b,
                  c)


def test_static_serving_tokens_kernel_vs_plain(cuda):
    cfg = smoke(get_config("mamba2_780m"))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.default_rng(5)
    args = {"prompts": [rng.integers(1, cfg.vocab, size=n).tolist()
                        for n in (5, 40, 17)], "max_new_tokens": 6,
            "pad_batch": 4}
    outs = []
    for use_kernel in (True, False):
        env = server.ServeEnv(model=Model(cfg, use_kernel=use_kernel),
                              params=params, device=cuda)
        ssd_intra.launches = 0
        outs.append(server.h_serve_batch(dict(args), env))
        assert ssd_intra.launches == (cfg.n_layers if use_kernel else 0)
    assert outs[0] == outs[1] and len(outs[0]["generated"]) == 3


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _mha_case(seed, b, sq, sk, h, kv, dh, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(device)
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


@pytest.mark.parametrize("shape,kw", [
    ((1, 128, 128, 2, 2, 64), {}),                   # the reference's sweep
    ((2, 256, 256, 4, 2, 128), {}),
    ((1, 128, 384, 4, 1, 128), {}),
    ((1, 200, 200, 2, 2, 80), {}),
    ((2, 256, 256, 4, 2, 128), dict(causal=False)),  # and its variants
    ((2, 256, 256, 4, 2, 128), dict(window=64)),
    ((2, 256, 256, 4, 2, 128), dict(softcap=50.0)),
    ((2, 256, 256, 4, 2, 128), dict(window=128, softcap=30.0)),
    ((1, 200, 200, 2, 2, 64), dict(causal=False)),   # the Pallas pad-key case
    ((1, 300, 130, 4, 2, 64), dict(causal=False)),   # Sq > Sk
    ((1, 300, 130, 4, 2, 64), dict(causal=False, window=50)),  # rows 179..
    ((2, 75, 75, 4, 2, 16), dict(window=1 << 30)),   # INF_WINDOW, smoke Dh
    ((4, 675, 675, 32, 8, 128), {}),                 # qwen3_4b's prefill
    ((1, 300, 300, 4, 2, 256), dict(window=100, softcap=50.0)),  # Dh 256
    ((2, 256, 256, 16, 8, 256), {}),                 # gemma2_9b's heads
    ((2, 200, 200, 4, 4, 128), {}),                  # one head a kv head
    ((1, 150, 150, 6, 2, 50), dict(window=40)),      # 4-byte copies, rep 3
    ((1, 4352, 4352, 16, 8, 256), dict(window=4096, softcap=50.0)),
    ((1, 1500, 1500, 12, 12, 64), dict(causal=False)),   # whisper encoder
    ((1, 40, 1500, 12, 12, 64), dict(causal=False)),     # whisper cross
    ((1, 4500, 4500, 32, 32, 64), dict(window=4096)),    # zamba2 shared
    ((2, 1280, 1280, 48, 8, 128), {}),                   # internvl2, rep 6
], ids=["mha", "gqa", "mqa_sk_gt_sq", "unaligned", "noncausal", "window",
        "softcap", "window_softcap", "noncausal_unaligned", "sq_gt_sk",
        "sq_gt_sk_window", "inf_window", "qwen3_full_width",
        "head_dim_256_window_softcap", "gemma2_heads_head_dim_256", "rep_1",
        "head_dim_not_multiple_of_4", "gemma2_layer_past_its_window",
        "whisper_encoder_1500", "whisper_cross_40_of_1500",
        "zamba2_shared_window_4096", "internvl2_heads_48_of_8"])
def test_flash_kernel_matches_plain(cuda, shape, kw):
    q, k, v = _mha_case(0, *shape, device=cuda)
    before = flash_mha.launches
    out = flash_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    ref = flash_mha_plain(q, k, v, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               equal_nan=False, **TOL)


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as the projections leave them may be views with any strides;
    the kernel reads them by their strides."""
    q, k, v = _mha_case(1, 2, 96, 96, 4, 2, 32, cuda)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)   # (B,S,H,Dh) view
    ks = torch.stack([k, torch.zeros_like(k)], -1).flatten(-2)[..., ::2]
    vs = torch.cat([v, v], dim=1)[:, 96:]                 # offset view
    assert ks.stride(-1) == 2 and not vs.is_contiguous()
    out = flash_mha(qs, ks, vs, window=40)
    ref = flash_mha_plain(q, k, v, window=40)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _mha_case(2, 1, 16, 16, 4, 2, 32, cuda)
    with pytest.raises(TypeError):
        flash_mha(q.double(), k, v)
    with pytest.raises(ValueError):  # 3 kv heads do not divide 4
        flash_mha(q, torch.cat([k, k[:, :, :1]], 2),
                  torch.cat([v, v[:, :, :1]], 2))
    with pytest.raises(ValueError):  # head_dim above the kernel's 256
        flash_mha(*(torch.cat([t] * 9, 3) for t in (q, k, v)))
    with pytest.raises(ValueError):
        flash_mha(q, k, v, window=0)


def test_dense_static_serving_tokens_kernel_vs_plain(cuda):
    cfg = smoke(get_config("qwen3_4b"))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.default_rng(6)
    args = {"prompts": [rng.integers(1, cfg.vocab, size=n).tolist()
                        for n in (5, 70, 17)], "max_new_tokens": 6,
            "pad_batch": 4}
    outs = []
    for use_kernel in (True, False):
        env = server.ServeEnv(model=Model(cfg, use_kernel=use_kernel),
                              params=params, device=cuda)
        flash_mha.launches = 0
        outs.append(server.h_serve_batch(dict(args), env))
        assert flash_mha.launches == (cfg.n_layers if use_kernel else 0)
    assert outs[0] == outs[1] and len(outs[0]["generated"]) == 3


@pytest.mark.parametrize("arch", ["gemma2_9b", "mixtral_8x7b"])
def test_windowed_static_serving_tokens_kernel_vs_plain(cuda, arch):
    """Smoke gemma2 (local/global windows) and mixtral (every layer
    windowed, moe): a prompt longer than the smoke window of 32, so that
    the kernel's window masks keys in the prefill."""
    cfg = smoke(get_config(arch))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.default_rng(6)
    args = {"prompts": [rng.integers(1, cfg.vocab, size=n).tolist()
                        for n in (5, 70, 17)], "max_new_tokens": 6}
    outs = []
    for use_kernel in (True, False):
        env = server.ServeEnv(model=Model(cfg, use_kernel=use_kernel),
                              params=params, device=cuda)
        flash_mha.launches = 0
        outs.append(server.h_serve_batch(dict(args), env))
        assert flash_mha.launches == (cfg.n_layers if use_kernel else 0)
    assert outs[0] == outs[1] and len(outs[0]["generated"]) == 3


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "whisper_small",
                                  "internvl2_26b"])
def test_new_family_static_serving_tokens_kernel_vs_plain(cuda, arch):
    """The hybrid, audio and vlm smoke configs served with the kernels and
    on the plain path give the same tokens; each prefill launches the SSD
    kernel once a mamba layer and flash once a shared-block application
    (hybrid), once an encoder layer and twice a decoder layer (audio), or
    once a layer (vlm)."""
    cfg = smoke(get_config(arch))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.default_rng(6)
    args = {"prompts": [rng.integers(1, cfg.vocab, size=n).tolist()
                        for n in (5, 70, 17)], "max_new_tokens": 6}
    want = {"zamba2_1p2b": (cfg.n_layers // max(cfg.hybrid_attn_every, 1),
                            cfg.n_layers),
            "whisper_small": (cfg.n_enc_layers + 2 * cfg.n_layers, 0),
            "internvl2_26b": (cfg.n_layers, 0)}[arch]
    outs = []
    for use_kernel in (True, False):
        env = server.ServeEnv(model=Model(cfg, use_kernel=use_kernel),
                              params=params, device=cuda)
        flash_mha.launches = ssd_intra.launches = 0
        outs.append(server.h_serve_batch(dict(args), env))
        assert (flash_mha.launches, ssd_intra.launches) == (
            want if use_kernel else (0, 0))
    assert outs[0] == outs[1] and len(outs[0]["generated"]) == 3


def test_moe_block_card_matches_cpu(cuda):
    """One mixtral_8x7b moe layer at full width (8 experts of 14336, top
    2) on random weights and a (2, 512) input: the card's routing and
    dispatch equal the CPU's, the output within atol 1e-4 x max|CPU| plus
    rtol 1e-4 (fp32 products over 4096 and 14336 terms in another order),
    the aux losses within 1e-5."""
    cfg = get_config("mixtral_8x7b")
    m = cfg.moe
    gen = torch.Generator().manual_seed(0)
    D, E, F = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {"router": torch.randn((D, E), generator=gen) / D ** 0.5,
         "w_gate": torch.randn((E, D, F), generator=gen) / D ** 0.5,
         "w_up": torch.randn((E, D, F), generator=gen) / D ** 0.5,
         "w_down": torch.randn((E, F, D), generator=gen) / F ** 0.5}
    x = torch.randn((2, 512, D), generator=gen)
    n = x.shape[0] * x.shape[1]
    out = {}
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        y, aux = moe.moe_block(x.to(dev), pd, cfg)
        top_e = moe.route(x.to(dev).reshape(n, D), pd["router"], m.top_k)[3]
        keep = moe.dispatch_plan(top_e, E, moe.capacity(
            n, E, m.top_k, m.capacity_factor))[3]
        out[str(dev)] = [t.cpu() for t in (y, aux["aux_lb"], aux["aux_z"],
                                           top_e, keep)]
        del pd
    (y, lb, z, e, k), (yc, lbc, zc, ec, kc) = out["cuda"], out["cpu"]
    assert torch.equal(e, ec) and torch.equal(k, kc)
    np.testing.assert_allclose(y.numpy(), yc.numpy(), rtol=1e-4,
                               atol=1e-4 * float(yc.abs().max()),
                               equal_nan=False)
    for a, b in ((lb, lbc), (z, zc)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def _train_batch(cfg, device, seed=7):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, size=(4, 33))
    labels = tok[:, 1:].copy()
    labels[:, :3] = -1
    return {"tokens": torch.as_tensor(tok[:, :-1], device=device),
            "labels": torch.as_tensor(labels, device=device)}


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_780m"])
def test_train_step_card_matches_cpu(cuda, arch, opt_name):
    cfg = smoke(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cpu", cuda):
        init_state, step = make_train_step(
            Model(cfg), OptimizerConfig(name=opt_name, lr=1e-3,
                                        warmup_steps=1),
            StepConfig(remat="full", microbatches=2))
        state = init_state(tree_map(lambda p: p.to(dev, copy=True), params))
        state, m = step(state, _train_batch(cfg, dev))
        out[str(dev)] = (m, state["params"])
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-5,
                                   atol=0, equal_nan=False)
    for a, b, p0 in zip(tree_leaves(pg), tree_leaves(pc),
                        tree_leaves(params)):
        assert torch.isfinite(a).all()
        err = torch.linalg.vector_norm(a.cpu() - b) \
            / torch.linalg.vector_norm(b - p0)
        assert err <= 1e-3, err


@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_780m"])
def test_loss_and_backward_launch_no_kernel(cuda, arch):
    """The loss runs the plain attention and SSD under autograd even where
    the model asks for the kernels (neither has a backward)."""
    cfg = smoke(get_config(arch))
    model = Model(cfg, use_kernel=True)
    params = tree_map(torch.Tensor.requires_grad_, init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda))
    for fn in (paged_attention, ssd_intra, flash_mha):
        fn.launches = 0
    loss, _ = model.loss_fn(params, _train_batch(cfg, cuda))
    loss.backward()
    torch.cuda.synchronize()
    assert (paged_attention.launches, ssd_intra.launches,
            flash_mha.launches) == (0, 0, 0)
    assert torch.isfinite(loss) and all(
        torch.isfinite(p.grad).all() for p in tree_leaves(params))
    # the prefill of the same model does launch its kernel
    with torch.no_grad():
        model.prefill(params, {"tokens": _train_batch(cfg, cuda)["tokens"]})
    assert (ssd_intra if arch == "mamba2_780m" else flash_mha).launches \
        == cfg.n_layers


def test_dryrun_argument_bytes_are_what_the_card_allocates(cuda):
    """``chip_smoke.py`` slice 8b's memory check on one cell: full-width
    mamba2_780m long_500k (params, SSM cache, tokens) built on the card
    requests the meta record's ``argument_bytes`` within 512 B a tensor;
    the broken control, a reckoning one layer short, must miss."""
    import dataclasses

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun

    cfg, sh = get_config("mamba2_780m"), SHAPES["long_500k"]
    rec = dryrun.run_cell("mamba2_780m", "long_500k", save=False,
                          verbose=False)
    torch.cuda.synchronize()
    req0 = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    g = torch.Generator(device="cuda").manual_seed(0)
    built = {"params": init_params(cfg, g, "cuda"),
             "cache": Model(cfg).init_cache(sh.global_batch, sh.seq_len),
             "tokens": torch.zeros((sh.global_batch, 1), dtype=torch.int32,
                                   device="cuda")}
    torch.cuda.synchronize()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"] \
        - req0  # the key is there once anything is allocated
    limit = 512 * len(tree_leaves(built))

    def within(argument_bytes):
        return 0 <= requested - argument_bytes <= limit

    assert within(rec["argument_bytes"]), (requested, rec["argument_bytes"])
    short = dryrun.trace_cell(
        Model(dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)), sh,
        opt_name="adamw", remat="full", microbatches=1, kv_chunk=1024,
        compress_grads=False)
    assert not within(dryrun.tree_bytes(short["args"]))
