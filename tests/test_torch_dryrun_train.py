"""The port's dry-run train cells against the reference's on the CPU:
for every ``train_4k`` cell, with AdamW and with Adafactor, the port's
meta parameters, optimizer state and inputs, and the new state and
metrics of one traced ``train_step``, have the shapes and dtypes of the
reference's ``jax.eval_shape`` of its own (floating ones fp32 in the
port), at full width and the reduced depth of
``tests/_torch_dryrun_parity.py``.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dryrun_parity import assert_cell_matches, ref_dryrun  # noqa: E402,F401
from repro_torch.configs.base import ARCH_IDS  # noqa: E402


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_cell_matches_the_reference(ref_dryrun, arch,  # noqa: F811
                                          opt_name):
    assert_cell_matches(ref_dryrun, arch, "train_4k", opt_name=opt_name)
