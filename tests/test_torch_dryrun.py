"""The port's dry-run against the reference's, cell by cell, on the CPU:
for every prefill and decode cell (the train cells are in
``test_torch_dryrun_train.py``), the port's meta parameters, cache,
inputs and outputs have the reference's abstract shapes and dtypes
(floating ones fp32 in the port), at full width and the reduced depth of
``tests/_torch_dryrun_parity.py``; the decode cells with the int8 K/V
cache too, where the family has attention caches. Two broken controls
show that the check sees a wrong cache.
"""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dryrun_parity import (assert_cell_matches, configs,  # noqa: E402
                                  mismatches, port_trees, ref_dryrun,  # noqa: F401
                                  reference_trees)
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402


def _cells(shape):
    return [a for a in ARCH_IDS if shape not in get_config(a).skip_shapes]


@pytest.mark.parametrize("arch", _cells("prefill_32k"))
def test_prefill_cell_matches_the_reference(ref_dryrun, arch):  # noqa: F811
    assert_cell_matches(ref_dryrun, arch, "prefill_32k")


DECODE_CELLS = [(a, s, q) for s in ("decode_32k", "long_500k")
                for a in _cells(s)
                for q in ((False,) if get_config(a).family == "ssm"
                          else (False, True))]


@pytest.mark.parametrize("arch,shape,kv_quant", DECODE_CELLS)
def test_decode_cell_matches_the_reference(ref_dryrun, arch,  # noqa: F811
                                           shape, kv_quant):
    assert_cell_matches(ref_dryrun, arch, shape, kv_quant=kv_quant)


def test_the_check_sees_a_cache_without_its_window(ref_dryrun):  # noqa: F811
    """mixtral's cache is its 4096-slot window; the port's config without
    the window keeps all 32768 positions, and the check must say so."""
    jcfg, tcfg = configs("mixtral_8x7b")
    want = reference_trees(ref_dryrun, jcfg, "decode_32k")
    got = port_trees(dataclasses.replace(tcfg, window=None), "decode_32k")
    bad = mismatches(got, want)
    assert any("/args/cache/attn/k: shape" in m and "32768" in m
               for m in bad), bad
    assert not mismatches(port_trees(tcfg, "decode_32k"), want)


def test_the_check_sees_an_fp32_cache_where_int8_is_asked(
        ref_dryrun):  # noqa: F811
    jcfg, tcfg = configs("zamba2_1p2b")
    want = reference_trees(ref_dryrun, jcfg, "long_500k", kv_quant=True)
    bad = mismatches(port_trees(tcfg, "long_500k"), want)
    assert "/args/cache/shared_attn: keys ['k', 'pos', 'v'] vs ['k', " \
        "'k_scale', 'pos', 'v', 'v_scale']" in bad, bad
