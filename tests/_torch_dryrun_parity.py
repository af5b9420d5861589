"""Shared checks of the port's dry-run (``repro_torch.launch.dryrun``)
against the reference's (``repro.launch.dryrun``), on the CPU.

The reference's trees come from its own abstract evaluation: the
``Model(...).abstract_params()`` / ``abstract_cache(B, S)`` value trees
and ``jax.eval_shape`` of its train step, prefill and decode step on its
``input_specs``, in bf16 as its dry-run builds them. The port's come from
``trace_cell`` on the meta device. Shapes and the tree's keys must be
equal, and dtypes too except the floating ones, which are fp32 in the
port (its model runs fp32).

Each cell runs at full width and a reduced depth that keeps every kind of
layer the config has: two layers (gemma2's local/global pair, one of
each), seven for the hybrid (one segment of six mamba2 layers with one
application of the shared block, and a remainder layer), the audio
family's encoder at one layer.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.params import split_params
from repro.optim.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.train_step import StepConfig as JaxStepConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models.model import Model


@pytest.fixture(scope="session")
def ref_dryrun():
    """The reference's dry-run module. Its import sets ``XLA_FLAGS`` to
    512 host devices (``dryrun.py:1-2``): the backend is started first and
    the variable restored after, so this process keeps one device."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert jax.device_count() == 1
    return mod


def reduced(cfg):
    """``cfg`` at full width and the reduced depth of the module
    docstring."""
    kw = {"n_layers": cfg.hybrid_attn_every + 1 if cfg.hybrid_attn_every
          else 2}
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 1
    return dataclasses.replace(cfg, **kw)


def configs(arch, **variant):
    """The reference's and the port's reduced configs of ``arch``, with
    ``variant`` replaced on both."""
    return (dataclasses.replace(reduced(jax_get_config(arch)), **variant),
            dataclasses.replace(reduced(get_config(arch)), **variant))


def mismatches(port, ref, path=""):
    """Where a tree of the port's meta tensors differs from a tree of the
    reference's ``ShapeDtypeStruct``s: keys, shapes, dtypes (a floating
    reference dtype wants fp32), or a port tensor that is not on meta."""
    if isinstance(ref, dict):
        if not isinstance(port, dict) or set(port) != set(ref):
            return [f"{path}: keys {sorted(port) if isinstance(port, dict) else type(port)}"
                    f" vs {sorted(ref)}"]
        return [m for k in sorted(ref)
                for m in mismatches(port[k], ref[k], f"{path}/{k}")]
    if isinstance(ref, (tuple, list)):
        if not isinstance(port, (tuple, list)) or len(port) != len(ref):
            return [f"{path}: {type(port)} vs {len(ref)} items"]
        return [m for i, (p, r) in enumerate(zip(port, ref))
                for m in mismatches(p, r, f"{path}/{i}")]
    want = ("float32" if jnp.issubdtype(ref.dtype, jnp.floating)
            else str(ref.dtype))
    got = str(port.dtype).replace("torch.", "")
    out = []
    if tuple(port.shape) != tuple(ref.shape):
        out.append(f"{path}: shape {tuple(port.shape)} vs {tuple(ref.shape)}")
    if got != want:
        out.append(f"{path}: dtype {got} vs {want} ({ref.dtype})")
    if port.device.type != "meta":
        out.append(f"{path}: on {port.device}")
    return out


def reference_trees(ref_dryrun, jcfg, shape_name, *, opt_name="adamw",
                    remat="full", kv_quant=False, kv_chunk=1024):
    """The reference's abstract arguments and outputs of one cell:
    ``{"args": {params, inputs[, opt][, cache]}, "outputs": ...}`` in the
    layout of ``dryrun.trace_cell``'s."""
    shape = JAX_SHAPES[shape_name]
    model = JaxModel(jcfg, dtype=jnp.bfloat16, kv_quant=kv_quant)
    params, _ = split_params(model.abstract_params())
    specs = ref_dryrun.input_specs(jcfg, shape)
    args = {"params": params, "inputs": specs}
    if shape.kind == "train":
        init_state, train_step = jax_make_train_step(
            model, JaxOptimizerConfig(name=opt_name),
            JaxStepConfig(remat=remat, kv_chunk=kv_chunk))
        state = jax.eval_shape(init_state, params)
        args["opt"] = state["opt"]
        new_state, metrics = jax.eval_shape(train_step, state, specs)
        outputs = {"state": new_state, "metrics": metrics}
    elif shape.kind == "prefill":
        logits, cache = jax.eval_shape(
            lambda p, b: model.prefill(p, b, kv_chunk=kv_chunk), params,
            specs)
        outputs = {"logits": logits, "cache": cache}
    else:
        args["cache"], _ = split_params(
            model.abstract_cache(shape.global_batch, shape.seq_len))
        logits, cache = jax.eval_shape(
            model.decode_step, params, args["cache"], specs["tokens"],
            jax.ShapeDtypeStruct((), jnp.int32))
        outputs = {"logits": logits, "cache": cache}
    return {"args": args, "outputs": outputs}


def port_trees(tcfg, shape_name, *, opt_name="adamw", remat="full",
               kv_quant=False, kv_chunk=1024):
    """The port's meta arguments and outputs of one cell (``trace_cell``
    on ``Model(tcfg, kv_quant=...)``, the kernel path)."""
    return dryrun.trace_cell(Model(tcfg, kv_quant=kv_quant),
                             SHAPES[shape_name], opt_name=opt_name,
                             remat=remat, microbatches=1, kv_chunk=kv_chunk,
                             compress_grads=False)


def assert_cell_matches(ref_dryrun, arch, shape_name, **kw):
    jcfg, tcfg = configs(arch)
    got = port_trees(tcfg, shape_name, **kw)
    want = reference_trees(ref_dryrun, jcfg, shape_name, **kw)
    bad = mismatches(got, want)
    assert not bad, bad[:10]
