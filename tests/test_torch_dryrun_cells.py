"""The port's dry-run (``repro_torch.launch.dryrun``) as a program, on the
CPU, and the pieces it needed: the meta branches of the two static-path
kernel wrappers and ``dispatch_plan`` on meta.

* ``run_cell`` at full depth on cheap cells gives every field of the
  record; the documented skips are ``skipped``; a prefill that raises is
  an ``error`` and ``main`` then exits 1 (the broken control).
* ``argument_bytes`` is what the same arguments hold when built for real
  on the CPU, and the meta trace's outputs have the shapes and dtypes of
  the same program run on the CPU (the kernel wrappers' plain versions),
  at smoke size: the CPU counterpart of ``chip_smoke.py`` slice 8b.
* ``flash_mha`` and ``ssd_intra`` on meta return their plain versions'
  output shapes, and refuse what ``_check`` refuses with its error; on a
  device with neither a kernel nor a plain path they still raise.
* ``dispatch_plan`` on meta gives the CPU's shapes and dtypes, and on the
  CPU each pair's rank within its expert (equal integers on any device).
"""
import dataclasses
import json
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,  # noqa: E402
                                      get_config, smoke)
from repro_torch.distributed import analytic, roofline  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import (StepConfig,  # noqa: E402
                                          make_train_step)

META = torch.device("meta")
RECORD_KEYS = {"arch", "shape", "mesh", "opt", "remat", "microbatches",
               "kv_chunk", "kv_quant", "tag", "status", "chips", "lower_s",
               "output_shapes", "argument_bytes", "argument_detail",
               "fits_hbm",
               "analytic_detail", "analytic_cache_bytes", "roofline"}
ROOFLINE_KEYS = {f.name for f in dataclasses.fields(roofline.Roofline)}


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("arch,shape,kv_quant", [
    ("whisper_small", "prefill_32k", False),
    ("mamba2_780m", "long_500k", False),
    ("zamba2_1p2b", "long_500k", True)])
def test_run_cell_at_full_depth_gives_every_field(results, arch, shape,
                                                  kv_quant):
    cell = dryrun.run_cell(arch, shape, kv_quant=kv_quant, verbose=False)
    assert cell["status"] == "ok", cell.get("traceback")
    assert set(cell) == RECORD_KEYS
    assert (cell["chips"], cell["mesh"]) == (1, "1")
    assert cell["argument_bytes"] == sum(cell["argument_detail"].values())
    assert cell["fits_hbm"] is (cell["argument_bytes"] <= 80e9)
    cfg, sh = get_config(arch), SHAPES[shape]
    cm = analytic.cost(cfg, sh, chips=1, model_shards=1, data_shards=1,
                       dtype_bytes=analytic.F32, kv_quant=kv_quant)
    assert cell["analytic_detail"] == cm.detail
    assert cell["analytic_cache_bytes"] == analytic.cache_bytes(cfg, sh,
                                                                kv_quant)
    rl = cell["roofline"]
    assert set(rl) == ROOFLINE_KEYS
    assert rl["collective_s"] == 0.0 and rl["chips"] == 1
    assert rl["step_time_s"] == max(rl["compute_s"], rl["memory_s"])
    assert rl["hlo_flops"] == cm.flops and rl["hlo_bytes"] == cm.hbm_bytes
    vpad = -(-cfg.vocab // 256) * 256
    assert cell["output_shapes"]["logits"] == [[sh.global_batch, 1, vpad],
                                               "float32"]
    saved = results / f"{arch}_{shape}_1_full_adamw.json"
    assert json.loads(saved.read_text()) == cell


def test_int8_cache_is_what_the_cells_count(results):
    fp32, int8 = (dryrun.run_cell("zamba2_1p2b", "long_500k", kv_quant=q,
                                  save=False, verbose=False)
                  for q in (False, True))
    cfg = get_config("zamba2_1p2b")
    # the shared block's K and V: 6 applications x 4096 slots x 32 x 64
    kv = 2 * (cfg.n_layers // cfg.hybrid_attn_every) * 4096 \
        * cfg.n_kv_heads * cfg.head_dim
    scales = kv // cfg.head_dim * 4  # one fp32 scale a head-dim vector
    assert fp32["argument_detail"]["cache"] \
        - int8["argument_detail"]["cache"] == kv * 4 - (kv + scales)
    assert int8["output_shapes"]["cache"]["shared_attn"]["k"][1] == "int8"


SKIPS = [(a, s) for a in ARCH_IDS for s in get_config(a).skip_shapes]


@pytest.mark.parametrize("arch,shape", SKIPS)
def test_documented_skips_are_skipped(results, arch, shape):
    cell = dryrun.run_cell(arch, shape, verbose=False)
    assert cell["status"] == "skipped"
    assert "argument_bytes" not in cell


def test_there_are_33_cells_and_7_skips():
    assert len(ARCH_IDS) * len(SHAPES) - len(SKIPS) == 33
    assert len(SKIPS) == 7


def test_main_runs_the_named_cells(results, capsys):
    cells = dryrun.main(["--arch", "whisper_small", "--shape",
                         "prefill_32k"])
    assert [c["status"] for c in cells.values()] == ["ok"]
    out = capsys.readouterr().out
    assert "dry-run: 1 ok, 0 skipped, 0 errors / 1 cells" in out
    assert "[ok     ] whisper_small" in out
    cells = dryrun.main(["--arch", "qwen3_4b", "--shape", "long_500k"])
    assert "dry-run: 0 ok, 1 skipped, 0 errors / 1 cells" \
        in capsys.readouterr().out


def test_a_prefill_that_raises_is_an_error_and_main_exits_1(
        results, monkeypatch, capsys):
    def broken(self, params, batch, **kw):
        raise RuntimeError("broken prefill")

    monkeypatch.setattr(dryrun.Model, "prefill", broken)
    cell = dryrun.run_cell("whisper_small", "prefill_32k", verbose=False)
    assert cell["status"] == "error"
    assert "broken prefill" in cell["error"] and "Traceback" in \
        cell["traceback"]
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "whisper_small", "--shape", "prefill_32k"])
    assert ex.value.code == 1
    assert "dry-run: 0 ok, 0 skipped, 1 errors / 1 cells" in \
        capsys.readouterr().out


# -- the meta trace against the same program run on the CPU ----------------

SMALL = {"train": ShapeConfig("train_small", 40, 2, "train"),
         "prefill": ShapeConfig("prefill_small", 40, 2, "prefill"),
         "decode": ShapeConfig("decode_small", 40, 2, "decode")}
CPU_CELLS = [(a, k, False) for a in ("qwen3_4b", "mixtral_8x7b",
                                     "mamba2_780m", "zamba2_1p2b",
                                     "whisper_small", "internvl2_26b")
             for k in ("train", "prefill", "decode")] + [
    (a, "decode", True) for a in ("gemma2_9b", "zamba2_1p2b")]


def _real(meta_tree, g):
    """CPU tensors of the meta tree's shapes and dtypes: token ids in
    [0, 100), floats unit normal."""
    if isinstance(meta_tree, dict):
        return {k: _real(v, g) for k, v in meta_tree.items()}
    if meta_tree.dtype.is_floating_point:
        return torch.randn(meta_tree.shape, generator=g)
    return torch.randint(0, 100, meta_tree.shape, generator=g,
                         dtype=meta_tree.dtype)


@pytest.mark.parametrize("arch,kind,kv_quant", CPU_CELLS)
def test_the_meta_trace_is_what_the_cpu_runs(arch, kind, kv_quant):
    cfg, shape = smoke(get_config(arch)), SMALL[kind]
    model = Model(cfg, kv_quant=kv_quant)
    kw = dict(opt_name="adafactor", remat="full", microbatches=1,
              kv_chunk=16, compress_grads=kind == "train")
    traced = dryrun.trace_cell(model, shape, **kw)

    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    inputs = _real(dryrun.input_specs(cfg, shape), g)
    args = {"params": params, "inputs": inputs}
    if kind == "train":
        init_state, train_step = make_train_step(
            model, OptimizerConfig(name="adafactor"),
            StepConfig(kv_chunk=16, compress_grads=True))
        state = init_state(params)
        args.update(opt=state["opt"], ef=state["ef"])
        new_state, metrics = train_step(state, inputs)
        outputs = {"state": new_state, "metrics": metrics}
        assert math.isfinite(metrics["loss"].item())
    elif kind == "prefill":
        logits, cache = model.prefill(params, inputs, kv_chunk=16)
        outputs = {"logits": logits, "cache": cache}
    else:
        args["cache"] = model.init_cache(shape.global_batch, shape.seq_len,
                                         device="cpu")
        logits, cache = model.decode_step(params, args["cache"],
                                          inputs["tokens"], shape.seq_len - 1)
        outputs = {"logits": logits, "cache": cache}
    assert all(t.device == META for t in tree_leaves(traced["args"]))
    assert dryrun.tree_specs(traced["args"]) == dryrun.tree_specs(args)
    assert dryrun.tree_specs(traced["outputs"]) == dryrun.tree_specs(outputs)
    assert dryrun.tree_bytes(traced["args"]) == sum(
        t.untyped_storage().nbytes() for t in tree_leaves(args))


# -- the kernel wrappers' meta branches -------------------------------------

def _meta(*ts):
    return [t.to(META) for t in ts]


def test_flash_mha_on_meta_has_the_plain_output_shape():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 5, 4, 16), (2, 7, 2, 16), (2, 7, 2, 16)))
    want = flash_attention.flash_mha_plain(q, k, v, window=3, softcap=5.0)
    got = flash_attention.flash_mha(*_meta(q, k, v), window=3, softcap=5.0)
    assert (got.device, got.shape, got.dtype) == (META, want.shape,
                                                  want.dtype)


@pytest.mark.parametrize("bad", ["head_dim_512", "kv_not_dividing_h",
                                 "fp64"])
def test_flash_mha_on_meta_refuses_what_check_refuses(bad):
    dh = 512 if bad == "head_dim_512" else 16
    kv = 3 if bad == "kv_not_dividing_h" else 2
    dtype = torch.float64 if bad == "fp64" else torch.float32
    q = torch.zeros((1, 4, 4, dh), dtype=dtype)
    k = torch.zeros((1, 4, kv, dh), dtype=dtype)
    with pytest.raises((ValueError, TypeError)) as want:
        flash_attention._check(q, k, k, None, None)
    with pytest.raises(want.type, match=re.escape(str(want.value))):
        flash_attention.flash_mha(*_meta(q, k, k))


def _ssd_inputs(n=16, q=8, p=12):
    rng = np.random.default_rng(1)
    b, nc, h, g = 2, 3, 4, 2

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    return (t(b, nc, q, h, p), t(b, nc, q, h).abs(), -t(h).abs(),
            t(b, nc, q, g, n), t(b, nc, q, g, n))


def test_ssd_intra_on_meta_has_the_plain_output_shapes():
    inputs = _ssd_inputs()
    want = ssd_scan.ssd_intra_plain(*inputs)
    got = ssd_scan.ssd_intra(*_meta(*inputs))
    assert [(t.device, t.shape, t.dtype) for t in got] == [
        (META, w.shape, w.dtype) for w in want]


@pytest.mark.parametrize("kw", [dict(n=ssd_scan.MAX_D_STATE + 1),
                                dict(q=ssd_scan.MAX_CHUNK + 1, n=4)],
                         ids=["d_state_over_max", "chunk_over_max"])
def test_ssd_intra_on_meta_refuses_what_check_refuses(kw):
    inputs = _ssd_inputs(**kw)
    with pytest.raises(ValueError) as want:
        ssd_scan._check(*inputs)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ssd_scan.ssd_intra(*_meta(*inputs))


class _OnXpu:
    """A stand-in for a tensor on a device with no kernel and no plain
    path (none exists on this machine)."""
    device = torch.device("xpu")


def test_ssd_intra_still_raises_on_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel for xpu"):
        ssd_scan.ssd_intra(*[_OnXpu()] * 5)


# -- dispatch_plan on meta --------------------------------------------------

@pytest.mark.parametrize("n_experts", [4, 9])
def test_dispatch_plan_runs_on_meta_and_ranks_within_each_expert(
        n_experts):
    g = torch.Generator().manual_seed(n_experts)
    # 9 experts for 2 x 12 pairs from 0..7: expert 8 gets none
    top_e = torch.randint(0, min(n_experts, 8), (12, 2), generator=g)
    order, e_sort, rank, keep = moe.dispatch_plan(top_e, n_experts, 3)
    flat = top_e.reshape(-1)
    assert torch.equal(e_sort, flat[order])
    assert torch.equal(e_sort, torch.sort(flat, stable=True).values)
    for i, e in enumerate(e_sort.tolist()):
        assert rank[i] == int((e_sort[:i] == e).sum())
    assert torch.equal(keep, rank < 3)
    on_meta = moe.dispatch_plan(top_e.to(META), n_experts, 3)
    assert [(t.device, t.shape, t.dtype) for t in on_meta] == [
        (META, t.shape, t.dtype) for t in (order, e_sort, rank, keep)]
