"""The port's ``distributed`` package against the reference's, on the CPU.

* ``analytic.cost`` and ``cache_bytes`` (a verbatim copy, held byte for
  byte by ``test_torch_core_copies.py``) give equal numbers in both
  packages for every (arch x shape) cell, with and without the int8 cache,
  under both optimizers, every remat mode and both dtypes, on one card
  and on the reference's 16 x 16 mesh: this holds the port's configs to the
  reference's as well.
* ``roofline`` keeps the reference's model with the H100's constants: the
  reference's ``test_roofline_math`` and ``test_analytic_cost_sanity``
  (``tests/test_system.py``) at the port's constants, and both
  ``analyze`` functions give the same terms when the inputs are scaled by
  the ratio of the two chips' rates.
"""
import ast
import itertools
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.distributed import analytic as jax_analytic  # noqa: E402
from repro.distributed import roofline as jax_roofline  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.distributed import analytic, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [dict(chips=1, model_shards=1, data_shards=1),
          dict(chips=256, model_shards=16, data_shards=16)]


def _cost(mod, cfg, shape, **kw):
    cm = mod.cost(cfg, shape, **kw)
    return cm.flops, cm.hbm_bytes, cm.coll_bytes, cm.detail


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_matches_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        for kv_quant in (False, True):
            assert analytic.cache_bytes(cfg, shape, kv_quant) == \
                jax_analytic.cache_bytes(jcfg, jshape, kv_quant)
            for opt_name, remat, mesh, dtype_bytes in itertools.product(
                    ("adamw", "adafactor"), ("none", "dots", "full"),
                    MESHES, (analytic.BF16, analytic.F32)):
                kw = dict(mesh, remat=remat, opt_name=opt_name,
                          kv_quant=kv_quant, dtype_bytes=dtype_bytes)
                assert _cost(analytic, cfg, shape, **kw) == \
                    _cost(jax_analytic, jcfg, jshape, **kw), (name, kw)
        assert roofline.model_flops_for(cfg, shape) == \
            jax_roofline.model_flops_for(jcfg, shape)


def test_one_card_has_no_collective_bytes():
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            cm = analytic.cost(get_config(arch), shape, **MESHES[0],
                               compress_grads=True)
            assert cm.coll_bytes == 0.0


def test_roofline_math():
    P, B, L = roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW
    r = roofline.analyze("a", "s", chips=256, hlo_flops=256 * P,
                         hlo_bytes=256 * B * 0.5, coll_bytes=256 * L * 0.25,
                         model_flops=256 * P * 0.8)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.mfu == pytest.approx(0.8)
    assert r.useful_ratio == pytest.approx(0.8)


def test_the_card_constants():
    """NVIDIA's H100 SXM data sheet at 700 W: fp32 outside the tensor
    cores, HBM3 rate and size, NVLink 4 each way."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES,
            roofline.LINK_BW) == (67e12, 3.35e12, 80e9, 450e9)


def test_analyze_scales_with_the_constants():
    """The same model: inputs scaled by the ratio of the two chips'
    rates give the reference's terms."""
    flops, hbm, coll, mf = 3.1e15, 2.2e12, 4.0e9, 1.7e15
    r = roofline.analyze("a", "s", 1, hlo_flops=flops, hlo_bytes=hbm,
                         coll_bytes=coll, model_flops=mf)
    f = jax_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS
    b = jax_roofline.HBM_BW / roofline.HBM_BW
    c = jax_roofline.LINK_BW / roofline.LINK_BW
    j = jax_roofline.analyze("a", "s", 1, hlo_flops=flops * f,
                             hlo_bytes=hbm * b, coll_bytes=coll * c,
                             model_flops=mf * f)
    for term in ("compute_s", "memory_s", "collective_s", "step_time_s",
                 "mfu", "useful_ratio"):
        assert getattr(r, term) == pytest.approx(getattr(j, term),
                                                 rel=1e-12), term
    assert r.bottleneck == j.bottleneck


def test_analytic_cost_sanity():
    """Analytic flops within 2x of 6ND for dense train, decode << train,
    and grad compression shrinks the collective bytes."""
    cfg = get_config("qwen3_4b")
    tr = analytic.cost(cfg, SHAPES["train_4k"], chips=256, model_shards=16,
                       data_shards=16, remat="none")
    floor = 6.0 * cfg.n_params() * SHAPES["train_4k"].global_batch \
        * SHAPES["train_4k"].seq_len
    assert floor < tr.flops < 2.0 * floor
    dec = analytic.cost(cfg, SHAPES["decode_32k"], chips=256,
                        model_shards=16, data_shards=16)
    assert dec.flops < tr.flops / 1000
    comp = analytic.cost(cfg, SHAPES["train_4k"], chips=256, model_shards=16,
                         data_shards=16, compress_grads=True)
    assert comp.coll_bytes < tr.coll_bytes


def test_chip_smoke_takes_the_card_peaks_from_roofline():
    """``chip_smoke.py`` keeps no second copy of the card's peaks."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {(n.module, a.name) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert {("repro_torch.distributed.roofline", "HBM_BW"),
            ("repro_torch.distributed.roofline", "PEAK_FLOPS")} <= imported
    assigned = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert not {"PEAK_BYTES_S", "PEAK_FP32_FLOP_S"} & assigned
