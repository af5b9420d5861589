"""The encoder-decoder family (``whisper_small``: the encoder over stub
frame embeddings plus learned positions, not causal; the decoder with
learned positions, causal self-attention and cross-attention to the
encoder's K/V) and the vlm family (``internvl2_26b``: the dense decoder
behind a prefix of stub patch embeddings) against the reference on the
CPU, on their smoke configs with the reference's parameters carried over:
prefill on seeded unit-normal frontend inputs with every cache leaf (the
decoder's K/V and positions, whisper's ``cross_k`` / ``cross_v``) and 4
decode steps (vlm's from ``plen + n_frontend_tokens``), the loss and its
gradients (vlm's logits with the prefix cut) under remat none, dots and full,
``h_serve_batch`` with its zero frontends, and the learned positions'
clamp past the 32768-row table. The copied config files are the
reference's. Broken controls: whisper's cross K/V zeroed in the cache,
and vlm's prefix dropped, must each miss the logits' limit.

Whisper's ``wq`` and ``wk`` (encoder, decoder and cross) are scaled by
1/4 on both sides, so that its smoke attention scores have a std near 1
rather than ~23: at the init rule's scale its float32 gradients are
ill-conditioned on both sides, ~100x the gradient limit from a float64
run of the same weights (the port's 98x, the reference's 100-225x), where
at 1/4 the port's are 0.14x from it.

Tolerances (``_torch_model_parity``): logits and cache leaves at rtol =
atol = 2e-4, the reference's model-logit tolerance
(``tests/test_models.py:84-86``), positions equal; the loss at 1e-5; the
gradients at rtol 1e-4, atol 4e-5 x the leaf's largest magnitude (the
smoke configs' float32 noise floor, as stated there); tokens and the
clamped position embeddings equal exactly.
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_model_parity as parity  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["whisper_small", "internvl2_26b"]
S = 40
_setup = parity.conditioned_setup


@pytest.mark.parametrize("arch", ["zamba2_1p2b"] + ARCHS)
def test_config_files_are_the_reference_copies(arch):
    want = (ROOT / "src" / "repro" / "configs" / f"{arch}.py").read_text()
    got = (ROOT / "src" / "repro_torch" / "configs" / f"{arch}.py"
           ).read_text()
    assert got == want


def test_smoke_configs_keep_what_the_tests_need():
    w, v = _setup("whisper_small")[1], _setup("internvl2_26b")[1]
    assert (w.family, w.n_enc_layers, w.enc_seq, w.pos_embedding,
            w.mlp_activation, w.mlp_gated, w.window) == \
        ("audio", 2, 16, "learned", "gelu", False, None)
    assert (v.family, v.n_frontend_tokens, v.tie_embeddings,
            v.n_heads // v.n_kv_heads) == ("vlm", 8, False, 2)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["flash_mha", "attention"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, use_kernel):
    """S = 40 with 4 extra slots: whisper's cache spans positions 0-43
    and its encoder K/V the 16 encoder rows of each layer; vlm's spans
    the 8 prefix positions too (0-51), and its decode steps write
    positions 48-51. ``use_kernel`` on CPU tensors runs the flash
    kernel's plain version, through its wrapper."""
    tc = parity.prefill_and_decode_tree(_setup(arch), use_kernel, S,
                                        extra=4)
    cfg = _setup(arch)[1]
    n = S + 4 + (cfg.n_frontend_tokens if arch == "internvl2_26b" else 0)
    assert tc["attn"]["pos"].tolist() == [list(range(n))] * cfg.n_layers
    if arch == "whisper_small":
        assert tc["cross_k"].shape == (cfg.n_layers, 2, cfg.enc_seq,
                                       cfg.n_kv_heads, cfg.head_dim)


def test_init_cache_matches_reference():
    """``init_cache`` of both families: the reference's tree of zeros
    (``pos`` -1), leaf for leaf."""
    for arch in ARCHS:
        jcfg, tcfg = _setup(arch)[:2]
        want = JaxModel(jcfg, dtype=jnp.float32).init_cache(2, 12)
        parity.close_tree(Model(tcfg).init_cache(2, 12, device="cpu"),
                          _values(want))


def _values(tree):
    """The reference's Param tree as arrays."""
    if isinstance(tree, dict):
        return {k: _values(v) for k, v in tree.items()}
    return np.asarray(tree.value)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    met = parity.loss_and_grads(_setup(arch), remat=remat)
    assert set(met) == {"loss"}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_matches_reference(arch):
    """Prompts of 5, 30 and 17 tokens with a pad row, 6 new tokens, the
    zero frontends of both servers: equal to the reference's
    ``h_serve_batch``."""
    cfg = _setup(arch)[1]
    got = parity.serve_batch(_setup(arch), {
        "prompts": parity.prompts(7, (5, 30, 17), cfg.vocab),
        "max_new_tokens": 6, "pad_batch": 4, "req_ids": ["a", "b", "c"]})
    assert got["prefill_len"] == 30 and len(got["generated"]) == 3


@pytest.mark.parametrize("cur", [0, 32767, 40000])
def test_learned_positions_clamp_past_the_table(cur):
    """Decode past the 32768-row position table: the reference slices at
    its traced ``jnp.int32(cur)`` with ``dynamic_slice``, which clamps
    the start into [0, 32768 - 1]; the port's int slice does the same."""
    jcfg, tcfg, jparams, tparams = _setup("whisper_small")
    tok = np.array([[3], [77]])
    want = JaxModel(jcfg, dtype=jnp.float32)._embed(
        jparams, jnp.asarray(tok, jnp.int32), pos0=jnp.int32(cur))
    got = Model(tcfg)._embed(tparams, torch.from_numpy(tok), pos0=cur)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = min(cur, (1 << 15) - 1)
    np.testing.assert_array_equal(
        got.numpy(), (tparams["embed"][tok[:, 0]]
                      + tparams["pos_embed"][row])[:, None].numpy())


def test_the_check_sees_the_cross_kv_zeroed():
    """Broken control: decode from the port's prefill cache with its
    encoder K/V zeroed must miss the reference's decode logits by more
    than LOGIT_TOL."""
    jcfg, tcfg, jparams, tparams = _setup("whisper_small")
    jb, tb = parity.as_batches(dict(
        tokens=parity.tokens(6, (2, S), tcfg.vocab),
        **parity.frontend(tcfg)))
    jm, tm = JaxModel(jcfg, dtype=jnp.float32), Model(tcfg)
    _, jc = jm.prefill(jparams, jb, extra_cache=1)
    with torch.no_grad():
        _, tc = tm.prefill(tparams, tb, extra_cache=1)
        tok = np.array([[3], [77]])
        jl, _ = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                               jnp.int32(S))
        tl, _ = tm.decode_step(tparams, tc, torch.from_numpy(tok), S)
        parity.close(tl, jl, **parity.LOGIT_TOL)
        broken = dict(tc, cross_k=torch.zeros_like(tc["cross_k"]),
                      cross_v=torch.zeros_like(tc["cross_v"]))
        bl, _ = tm.decode_step(tparams, broken, torch.from_numpy(tok), S)
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        parity.close(bl, jl, **parity.LOGIT_TOL)


def test_the_check_sees_the_prefix_dropped():
    """Broken control: the port's vlm prefill with the patch prefix
    dropped (zero prefix rows) must miss the reference's prefill logits
    by more than LOGIT_TOL."""
    jcfg, tcfg, jparams, tparams = _setup("internvl2_26b")
    jb, tb = parity.as_batches(dict(
        tokens=parity.tokens(6, (2, S), tcfg.vocab),
        **parity.frontend(tcfg)))
    jl, _ = JaxModel(jcfg, dtype=jnp.float32).prefill(jparams, jb)
    with torch.no_grad():
        tl, _ = Model(tcfg).prefill(tparams, tb)
        parity.close(tl, jl, **parity.LOGIT_TOL)
        dropped, _ = Model(tcfg).prefill(
            tparams, dict(tb, patch_embed=tb["patch_embed"][:, :0]))
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        parity.close(dropped, jl, **parity.LOGIT_TOL)
