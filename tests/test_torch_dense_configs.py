"""The three dense configs that the port gained after qwen3_4b —
``gemma2_9b`` (local/global windows, both softcaps, scaled embeddings,
gelu, head dim 16 in the smoke config), ``chatglm3_6b`` (half-dim RoPE,
an untied head) and ``codeqwen15_7b`` (untied head; rep 2 in the smoke
config, whose kv heads ``smoke()`` caps at 2, and rep 1 with
``n_kv_heads = n_heads``) — against the reference on the CPU, on their
smoke configs with the reference's parameters carried over: prefill plus
4 decode steps at S = 40 (longer than the smoke window of 32), the loss
and its gradients, ``h_serve_batch``, and the continuous engine for
chatglm3 and codeqwen. The copied config files are the reference's.

Tolerances (``_torch_model_parity``): logits and K/V at rtol = atol =
2e-4, the reference's model-logit tolerance (``tests/test_models.py:84-86``);
the loss at 1e-5 (``test_torch_train.py``'s); the gradients at rtol 1e-4,
atol 4e-5 x the leaf's largest magnitude, which is 4x the training tests'
atol because that one is the float32 noise floor of these configs'
gradients (the reference against itself, jitted vs op by op, reaches
0.24-0.87 x it; ``_torch_model_parity`` has the numbers), beside a
control that leaves one of each config's options out on the port's side
and must miss; tokens equal exactly.
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_model_parity as parity  # noqa: E402
from repro.serving.engine import PagedEngine as JaxEngine  # noqa: E402
from repro_torch.models.model import INF_WINDOW, Model  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# arch id and config variant; codeqwen_rep1 puts a kv head beside every
# query head, as the full config has
CASES = {"gemma2": ("gemma2_9b", {}),
         "chatglm3": ("chatglm3_6b", {}),
         "codeqwen": ("codeqwen15_7b", {}),
         "codeqwen_rep1": ("codeqwen15_7b", {"n_kv_heads": 4})}
S = 40  # longer than the smoke window (32)
_SETUPS = {}


def _setup(case):
    if case not in _SETUPS:
        arch, variant = CASES[case]
        _SETUPS[case] = parity.setup(arch, **variant)
    return _SETUPS[case]


@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_780m", "gemma2_9b",
                                  "chatglm3_6b", "codeqwen15_7b",
                                  "mixtral_8x7b", "kimi_k2_1t_a32b"])
def test_config_files_are_the_reference_copies(arch):
    want = (ROOT / "src" / "repro" / "configs" / f"{arch}.py").read_text()
    got = (ROOT / "src" / "repro_torch" / "configs" / f"{arch}.py"
           ).read_text()
    assert got == want


def test_smoke_configs_keep_what_the_tests_need():
    g = _setup("gemma2")[1]
    assert (g.window, g.local_global_pattern, g.attn_softcap,
            g.final_softcap, g.scale_embeddings, g.mlp_activation) == \
        (32, True, 50.0, 30.0, True, "gelu")
    assert Model(g)._window_array() == [32, INF_WINDOW]
    c = _setup("chatglm3")[1]
    assert (c.rope_fraction, c.tie_embeddings, c.n_heads // c.n_kv_heads) \
        == (0.5, False, 2)
    assert [_setup(k)[1].n_heads // _setup(k)[1].n_kv_heads
            for k in ("codeqwen", "codeqwen_rep1")] == [2, 1]


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["flash_mha", "attention"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case, use_kernel):
    """With 4 extra slots the cache holds S + 4 positions (none of these
    configs has a ring buffer: gemma2's windows alternate, so its cache
    spans the prompt), and the decode steps write slots 40-43."""
    n_slots, pos = parity.prefill_and_decode(_setup(case), use_kernel, S,
                                             extra=4)
    assert n_slots == S + 4 and pos == list(range(S + 4))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference(case):
    met = parity.loss_and_grads(_setup(case))
    assert set(met) == {"loss"}


@pytest.mark.parametrize("case,broken", [
    ("gemma2", {"scale_embeddings": False}),
    ("gemma2", {"attn_softcap": None}),
    ("gemma2", {"final_softcap": None}),
    ("gemma2", {"mlp_activation": "silu"}),
    ("chatglm3", {"rope_fraction": 1.0}),
    ("codeqwen", {"rope_theta": 10000.0})],
    ids=["gemma2_scale_embeddings", "gemma2_attn_softcap",
         "gemma2_final_softcap", "gemma2_silu", "chatglm3_full_rope",
         "codeqwen_rope_theta"])
def test_the_gradient_check_sees_a_wrong_option(case, broken):
    """Broken controls: with one option of the config left out on the
    port's side, the loss or the gradients miss their limits."""
    with pytest.raises(AssertionError):
        parity.loss_and_grads(_setup(case), **broken)


@pytest.mark.parametrize("case", list(CASES))
def test_h_serve_batch_matches_reference(case):
    """A ragged batch (left pad) padded to 4 rows, the first prompt
    longer than the smoke window."""
    vocab = _setup(case)[1].vocab
    got = parity.serve_batch(_setup(case), {
        "prompts": parity.prompts(3, (37, 9, 21), vocab),
        "max_new_tokens": 5, "pad_batch": 4})
    assert got["prefill_len"] == 37 and len(got["generated"]) == 3


@pytest.mark.parametrize("case", ["chatglm3", "codeqwen", "codeqwen_rep1"])
def test_continuous_engine_matches_reference(case):
    """Staggered admissions into 3 lanes: the same tokens, and mid-run the
    same K/V in the same pool slots."""
    jcfg, tcfg, jparams, tparams = _setup(case)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab, size=n).tolist()
               for n in (5, 19, 13, 2)]
    kw = dict(max_batch=3, num_pages=32, page_size=8)
    results = []
    for eng in (JaxEngine(jcfg, params=jparams, **kw),
                PagedEngine(tcfg, params=tparams, device="cpu", **kw)):
        queue = list(enumerate(prompts))
        done, snap = {}, None
        while queue or eng.n_inflight:
            if queue and eng.can_admit(len(queue[0][1]), 6):
                i, p = queue.pop(0)
                assert eng.admit(f"r{i}", p, 6)
            for s in eng.step():
                done[s.req_id] = s.tokens
            if eng.n_steps == 3 and snap is None:
                snap = [np.array(eng.pool.k), np.array(eng.pool.v)]
            assert eng.n_steps < 60
        results += [snap, done]
    (jk, jv), jdone, (tk, tv), tdone = results
    assert jdone == tdone and len(jdone) == 4
    parity.close(tk, jk, **parity.LOGIT_TOL)
    parity.close(tv, jv, **parity.LOGIT_TOL)


def test_the_engine_refuses_windowed_configs():
    """The paged engine serves no sliding window, as the reference's: gemma2
    runs only the static path."""
    with pytest.raises(AssertionError, match="sliding-window"):
        PagedEngine(_setup("gemma2")[1], device="cpu")
