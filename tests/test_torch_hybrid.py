"""The hybrid family (``zamba2_1p2b``: mamba2 layers and ONE shared
attention+MLP block after every ``hybrid_attn_every``-th layer, the
shared block's attention windowed) against the reference on the CPU, with
the reference's parameters carried over: the smoke config (2 layers, the
shared block after both: one segment) and a 5-layer variant at
``hybrid_attn_every = 2`` (two segments, then a remainder layer with no
shared block after it). Prefill with every cache leaf (the ssm and conv
states of every layer, the shared block's K/V and slot positions for each
application) and 4 decode steps from a 40-token prompt (past the smoke
window of 32: the shared cache is a ring buffer) and from a 20-token one
(the cache grows toward the window), the loss and its gradients under
remat none, dots and full, and ``h_serve_batch``; beside a broken control, the
shared block skipped at the last segment, which must miss the logits'
limit, and a control of the gradients alone, the gradient through the
last segment's shared block cut by a hundredth, which must miss the
gradients' limit.

Tolerances (``_torch_model_parity``): logits and cache leaves at rtol =
atol = 2e-4, the reference's model-logit tolerance
(``tests/test_models.py:84-86``), on the smoke config; the five-layer
variant's at 4x that, its float32 noise floor: the reference's own
prefill logits lie 0.72-0.86 x 2e-4 from a float64 run of the same
weights (the port in float64), the port's 0.43-1.29 x, and the port's
from the reference's 0.60-1.19 x (40- and 20-token prompts; the smoke
config's 0.14-0.40 x). Positions equal; the loss at 1e-5; the
gradients at rtol 1e-4, atol 4e-5 x the leaf's largest magnitude (the
float32 noise floor of the smoke configs' gradients, as stated there) on
the smoke config, and at 10x both on the five-layer variant, whose
float32 gradients through five SSD layers are noisier on the reference's
side: against a float64 run of the same weights (the port in float64),
the reference's jitted gradient reaches 7.3 x the 4e-5 limit (``A_log``;
1.5-5.3 x on the other mamba leaves), its op-by-op one 2.4 x from its
jitted one, the port's 1.1 x, and the port from the reference 8.2 x.
Tokens equal exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_model_parity as parity  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.model import INF_WINDOW, Model  # noqa: E402

torch.set_num_threads(1)
ARCH = "zamba2_1p2b"
# config variant: the smoke config, and five layers in two segments of
# two plus a remainder layer
CASES = {"smoke": {}, "five_layers": {"n_layers": 5}}
# logits and cache tolerance of each case (the module docstring says why)
TOL = {"smoke": parity.LOGIT_TOL,
       "five_layers": dict(rtol=8e-4, atol=8e-4, equal_nan=False)}
GRAD_TOL = {"smoke": dict(grad_rtol=parity.GRAD_RTOL,
                          grad_atol=parity.GRAD_ATOL),
            "five_layers": dict(grad_rtol=10 * parity.GRAD_RTOL,
                                grad_atol=10 * parity.GRAD_ATOL)}
_SETUPS = {}


def _setup(case):
    if case not in _SETUPS:
        _SETUPS[case] = parity.setup(ARCH, **CASES[case])
    return _SETUPS[case]


def test_smoke_configs_keep_what_the_tests_need():
    cfgs = [_setup(c)[1] for c in CASES]
    assert [(c.family, c.n_layers, c.hybrid_attn_every, c.window)
            for c in cfgs] == [("hybrid", 2, 2, 32), ("hybrid", 5, 2, 32)]
    assert [divmod(c.n_layers, c.hybrid_attn_every) for c in cfgs] == \
        [(1, 0), (2, 1)]
    # the window is the shared block's: every layer's entry stays INF
    assert Model(cfgs[1])._window_array() == [INF_WINDOW] * 5


@pytest.mark.parametrize("S", [40, 20])
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernels", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case, use_kernel, S):
    """At S = 40 the shared cache keeps the last 32 positions (8-39) in
    slots 0-31 with no extra slot, and decode writes positions 40-43 at
    slots ``cur % 32`` = 8-11; at S = 20 it gets 4 extra slots (24 <
    32) and decode writes slots 20-23. ``use_kernel`` on CPU tensors runs
    each kernel's plain version, through the kernel's wrapper."""
    tc = parity.prefill_and_decode_tree(_setup(case), use_kernel, S,
                                        extra=4, tol=TOL[case])
    cfg = _setup(case)[1]
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    pos = tc["shared_attn"]["pos"]
    assert tc["ssm"]["state"].shape[0] == cfg.n_layers
    assert tc["shared_attn"]["k"].shape[:3] == (n_apps, 2,
                                                32 if S == 40 else 24)
    want = (list(range(8, 16)) + list(range(40, 44)) + list(range(20, 40))
            if S == 40 else list(range(24)))
    assert pos.tolist() == [want] * n_apps


def test_init_cache_decodes_as_the_prefill():
    """Greedy decode from ``init_cache`` over 13 tokens gives the
    prefill's last logits (the reference's consistency check, on the
    port); the shared cache holds min(window, 13) slots an application."""
    _, tcfg, _, tparams = _setup("five_layers")
    model = Model(tcfg)
    toks = torch.from_numpy(parity.tokens(14, (1, 13), tcfg.vocab))
    with torch.no_grad():
        full, _ = model.prefill(tparams, {"tokens": toks})
        cache = model.init_cache(1, 13, device="cpu")
        assert cache["shared_attn"]["k"].shape == (2, 1, 13, 2, 16)
        for t in range(13):
            logits, cache = model.decode_step(tparams, cache,
                                              toks[:, t:t + 1], t)
    parity.close(logits[:, 0], full[:, -1], **TOL["five_layers"])


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference(case, remat):
    met = parity.loss_and_grads(_setup(case), remat=remat, **GRAD_TOL[case])
    assert set(met) == {"loss"}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_batch_matches_reference(case):
    """Prompts of 5, 40 and 17 tokens (left-padded to 40, past the
    window) with a pad row, 6 new tokens: equal to the reference's
    ``h_serve_batch``."""
    cfg = _setup(case)[1]
    got = parity.serve_batch(_setup(case), {
        "prompts": parity.prompts(5, (5, 40, 17), cfg.vocab),
        "max_new_tokens": 6, "pad_batch": 4, "req_ids": ["a", "b", "c"]})
    assert got["prefill_len"] == 40 and len(got["generated"]) == 3


@pytest.mark.parametrize("case", list(CASES))
def test_the_check_sees_the_last_segment_skipped(case, monkeypatch):
    """Broken control: the port with the shared block skipped at the last
    segment (its attention output and its MLP output zeroed, so x passes
    it unchanged) must miss the reference's prefill logits by more than
    the case's tolerance."""
    cfg = _setup(case)[1]
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    calls = {"attn_out": 0, "mlp_block": 0}

    def skipped_at_last(name):
        fn = getattr(model_lib, name)

        def wrapped(*args):
            calls[name] += 1
            y = fn(*args)
            return torch.zeros_like(y) if calls[name] == n_apps else y
        return wrapped
    for name in calls:
        monkeypatch.setattr(model_lib, name, skipped_at_last(name))
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        parity.prefill_and_decode_tree(_setup(case), False, 40, extra=4,
                                       tol=TOL[case])
    assert calls == {"attn_out": n_apps, "mlp_block": n_apps}


@pytest.mark.parametrize("case", list(CASES))
def test_the_gradient_check_sees_the_last_segment_cut_from_the_backward(
        case, monkeypatch):
    """Broken control of the gradients alone: the port's training forward
    unchanged, but the gradient through the shared block's attention and
    MLP outputs at the last segment scaled by 0.99 (``y.detach() + 0.99 *
    (y - y.detach())``, y in the forward), as a backward that loses a
    hundredth of that application would. The loss stays bit-equal to the
    unbroken port's; the gradients must miss the case's limits (measured:
    the largest error is 80x the smoke limit and 11x the five-layer
    case's 10x one, where the port's own is 0.30x and 0.82x)."""
    _, tcfg, _, tparams = _setup(case)
    n_apps = tcfg.n_layers // tcfg.hybrid_attn_every
    calls = {"self_attention_block": 0, "mlp_block": 0}
    b = parity.as_batches(parity.batch(tcfg.vocab))[1]
    with torch.no_grad():
        want = Model(tcfg).loss_fn(tparams, b)[0]

    def cut_at_last(name):
        fn = getattr(model_lib, name)

        def wrapped(*args, **kw):
            calls[name] += 1
            y = fn(*args, **kw)
            return (y.detach() + 0.99 * (y - y.detach())
                    if calls[name] % n_apps == 0 else y)
        return wrapped
    for name in calls:
        monkeypatch.setattr(model_lib, name, cut_at_last(name))
    with torch.no_grad():
        assert torch.equal(Model(tcfg).loss_fn(tparams, b)[0], want)
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        parity.loss_and_grads(_setup(case), **GRAD_TOL[case])
    assert calls == {"self_attention_block": 2 * n_apps,
                     "mlp_block": 2 * n_apps}
