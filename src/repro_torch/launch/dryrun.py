"""Dry-run of every (arch x shape) cell on one card: build each cell's
program at full size on PyTorch's meta device, prove that it is coherent
(every shape and every kernel precondition holds through one train step,
prefill or decode step), and reckon its work against the H100's roofline.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell on 512 placeholder TPU devices. Here a cell's
parameters, optimizer state, cache and inputs are meta tensors (shapes
and dtypes, no storage), and one call of the cell's program is traced on
them through the same ``Model`` (with ``use_kernel=True``: the kernel
wrappers check their limits and return meta outputs) and the same
``make_train_step`` that the launchers run on the card. No tensor of a
cell is allocated on the card or the host, so the dry-run needs no card.

Differences by design from the reference's dry-run:

* a meta trace has no buffer assignment, so there is no temp-buffer
  analysis: ``fits_hbm`` covers the arguments alone (parameters,
  optimizer state, cache and inputs, ``argument_bytes``) against the
  card's ``HBM_BYTES``, and no ``suggested_microbatches`` is given;
* one card has no mesh: ``multi_pod``, ``mesh_shape``, ``zero_stage`` and
  ``seq_parallel`` are gone, ``chips`` is 1 and ``mesh`` is ``"1"``, and
  there is no collective census (the roofline's collective term is 0);
* the port's model runs fp32 where the reference's dry-run builds bf16,
  so ``argument_bytes`` counts fp32 parameters and caches, and the
  roofline is costed at ``dtype_bytes=F32``. The verbatim
  ``analytic.cache_bytes`` counts an unquantized K/V cache and the SSM
  conv state at bf16 whatever the dtype (and the hybrid's K/V so with
  ``kv_quant`` too), so ``analytic_cache_bytes`` is about half of the fp32
  K/V cache that ``argument_detail["cache"]`` counts; the record keeps
  both.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 cells
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from ..configs.base import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig,
                            get_config)
from ..distributed import analytic, roofline
from ..models.model import Model
from ..models.params import init_params, tree_leaves
from ..optim.optimizer import OptimizerConfig
from ..train.train_step import StepConfig, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input (no allocation), the
    reference's shapes: int32 tokens (and labels), fp32 frontends."""
    B, S = shape.global_batch, shape.seq_len

    def tokens(s):
        return torch.empty((B, s), dtype=torch.int32, device=META)

    s_text = S - cfg.n_frontend_tokens if cfg.family == "vlm" else S
    if shape.kind == "train":
        specs = {"tokens": tokens(s_text), "labels": tokens(s_text)}
    elif shape.kind == "prefill":
        specs = {"tokens": tokens(s_text)}
    else:  # decode: one new token against a seq_len cache
        specs = {"tokens": tokens(1)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patch_embed"] = torch.empty(
            (B, cfg.n_frontend_tokens, cfg.d_model), device=META)
    if cfg.family == "audio" and shape.kind != "decode":
        specs["frame_embed"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                           device=META)
    return specs


def tree_bytes(tree: Any) -> int:
    """numel x element size summed over the tensors of a nested dict."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_specs(tree: Any) -> Any:
    """The nested dict's tensors as ``[shape, dtype]`` (JSON-ready)."""
    if isinstance(tree, dict):
        return {k: tree_specs(v) for k, v in tree.items()}
    return [list(tree.shape), str(tree.dtype).replace("torch.", "")]


def trace_cell(model: Model, shape: ShapeConfig, *, opt_name: str,
               remat: str, microbatches: int, kv_chunk: int,
               compress_grads: bool) -> Dict[str, Any]:
    """Build the cell's arguments on meta and trace one call of its
    program. Returns the arguments by part and the outputs."""
    cfg = model.cfg
    params = init_params(cfg, torch.Generator(), META)  # meta draws nothing
    args: Dict[str, Any] = {"params": params,
                            "inputs": input_specs(cfg, shape)}
    if shape.kind == "train":
        init_state, train_step = make_train_step(
            model, OptimizerConfig(name=opt_name),
            StepConfig(remat=remat, microbatches=microbatches,
                       kv_chunk=kv_chunk, compress_grads=compress_grads))
        state = init_state(params)
        args["opt"] = state["opt"]
        if compress_grads:
            args["ef"] = state["ef"]
        new_state, metrics = train_step(state, args["inputs"])
        outputs = {"state": new_state, "metrics": metrics}
    elif shape.kind == "prefill":
        logits, cache = model.prefill(params, args["inputs"],
                                      kv_chunk=kv_chunk)
        outputs = {"logits": logits, "cache": cache}
    else:  # decode: one step at the last position the cache holds
        args["cache"] = model.init_cache(shape.global_batch, shape.seq_len,
                                         device=META)
        logits, cache = model.decode_step(params, args["cache"],
                                          args["inputs"]["tokens"],
                                          shape.seq_len - 1)
        outputs = {"logits": logits, "cache": cache}
    return {"args": args, "outputs": outputs}


def run_cell(arch_id: str, shape_name: str, *, opt_name: str = "adamw",
             remat: str = "full", microbatches: int = 1,
             kv_chunk: int = 1024, kv_quant: bool = False, save: bool = True,
             verbose: bool = True, extra_tag: str = "") -> Dict[str, Any]:
    """Trace one cell and return its record (saved under
    ``RESULTS_DIR``); a cell that raises gives ``status == "error"``."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    cell = {"arch": arch_id, "shape": shape_name, "mesh": "1",
            "opt": opt_name, "remat": remat, "microbatches": microbatches,
            "kv_chunk": kv_chunk, "kv_quant": kv_quant, "tag": extra_tag}
    if shape_name in cfg.skip_shapes:
        cell.update(status="skipped",
                    reason="documented skip (the config's skip_shapes)")
        return _finish(cell, save, verbose)

    t0 = time.time()
    try:
        model = Model(cfg, kv_quant=kv_quant)
        traced = trace_cell(model, shape, opt_name=opt_name, remat=remat,
                            microbatches=microbatches, kv_chunk=kv_chunk,
                            compress_grads=False)
        t_lower = time.time() - t0
        detail = {part: tree_bytes(tree)
                  for part, tree in traced["args"].items()}
        args_b = sum(detail.values())
        cm = analytic.cost(cfg, shape, chips=1, model_shards=1,
                           data_shards=1, remat=remat,
                           dtype_bytes=analytic.F32, opt_name=opt_name,
                           kv_quant=kv_quant)
        rl = roofline.analyze(arch_id, shape_name, 1, hlo_flops=cm.flops,
                              hlo_bytes=cm.hbm_bytes,
                              coll_bytes=cm.coll_bytes,
                              model_flops=roofline.model_flops_for(cfg,
                                                                   shape))
        cell.update(
            status="ok", chips=1, lower_s=round(t_lower, 1),
            output_shapes=tree_specs(traced["outputs"]),
            argument_bytes=args_b, argument_detail=detail,
            fits_hbm=bool(args_b <= roofline.HBM_BYTES),
            analytic_detail={k: float(v) for k, v in cm.detail.items()},
            analytic_cache_bytes=(analytic.cache_bytes(cfg, shape, kv_quant)
                                  if shape.kind != "train" else 0.0),
            roofline=rl.to_dict())
    except Exception as ex:  # noqa: BLE001 — a failed cell is a record
        cell.update(status="error", error=repr(ex),
                    traceback=traceback.format_exc()[-4000:])
    return _finish(cell, save, verbose)


def _finish(cell: Dict[str, Any], save: bool, verbose: bool
            ) -> Dict[str, Any]:
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        tag = f"_{cell['tag']}" if cell.get("tag") else ""
        path = os.path.join(
            RESULTS_DIR,
            f"{cell['arch']}_{cell['shape']}_{cell['mesh']}"
            f"_{cell['remat']}_{cell['opt']}{tag}.json")
        with open(path, "w") as f:
            json.dump(cell, f, indent=1)
    if verbose:
        rl = cell.get("roofline", {})
        print(f"[{cell['status']:7s}] {cell['arch']:18s} {cell['shape']:12s} "
              f"{cell['mesh']:8s} "
              f"bottleneck={rl.get('bottleneck', '-'):10s} "
              f"step={rl.get('step_time_s', 0):.4f}s "
              f"mfu={rl.get('mfu', 0):.3f} "
              f"args={cell.get('argument_bytes', 0) / 1e9:.2f}GB "
              f"fits_hbm={cell.get('fits_hbm', '-')} "
              f"lower={cell.get('lower_s', 0)}s"
              + (" kv_quant" if cell["kv_quant"] else "")
              + (f" err={cell.get('error', '')[:100]}"
                 if cell["status"] == "error" else ""))
    return cell


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    """Run the cells that ``argv`` names; exits 1 on any error. Returns
    the records by ``(arch, shape)`` when none failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    cells = {}
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            cells[a, s] = run_cell(a, s, opt_name=args.opt,
                                   remat=args.remat,
                                   microbatches=args.microbatches,
                                   kv_chunk=args.kv_chunk,
                                   extra_tag=args.tag)
    n_ok = sum(c["status"] == "ok" for c in cells.values())
    n_skip = sum(c["status"] == "skipped" for c in cells.values())
    n_err = len(cells) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(cells)} cells")
    if n_err:
        raise SystemExit(1)
    return cells


if __name__ == "__main__":
    main()
