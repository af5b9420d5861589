"""Three-term roofline model for one NVIDIA H100 SXM (the port's card).

    compute term    = FLOPs       / (chips * PEAK_FLOPS)
    memory term     = HBM bytes   / (chips * HBM_BW)
    collective term = coll_bytes  / (chips * LINK_BW)

The same model and names as the reference's ``distributed/roofline.py``;
only the constants are the card's, from NVIDIA's H100 SXM data sheet at
its 700 W power limit (dense rates). The port's arithmetic is fp32 with
TF32 off (``repro_torch.device``), so the compute peak is fp32 outside the
tensor cores; bf16 on the tensor cores would be 989e12 FLOP/s. The
FLOPs and bytes come from ``analytic.cost``. MODEL_FLOPS = 6*N*D (dense)
or 6*N_active*D (MoE) gives the useful-compute ratio. On one card
``analytic.cost`` counts no collective bytes, so that term is 0; NVLink's
rate applies only across cards.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Any, Dict

PEAK_FLOPS = 67e12       # fp32 FLOP/s per H100 SXM, outside tensor cores
HBM_BW = 3.35e12         # bytes/s of HBM3 per card
LINK_BW = 450e9          # bytes/s per card each way over NVLink 4 (900 GB/s both)
HBM_BYTES = 80e9         # bytes of HBM3 per card


@dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float
    step_time_s: float
    mfu: float

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def analyze(arch: str, shape: str, chips: int, *, hlo_flops: float,
            hlo_bytes: float, coll_bytes: float, model_flops: float
            ) -> Roofline:
    """The three terms, the largest as the bottleneck and the step time.
    The ``hlo_*`` names are the reference's; here they hold the analytic
    model's FLOPs and bytes."""
    compute_s = hlo_flops / (chips * PEAK_FLOPS)
    memory_s = hlo_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    mfu = (model_flops / (chips * PEAK_FLOPS)) / step if step > 0 else 0.0
    return Roofline(
        arch=arch, shape=shape, chips=chips, hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes, coll_bytes=coll_bytes, model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck,
        useful_ratio=(model_flops / hlo_flops) if hlo_flops else 0.0,
        step_time_s=step, mfu=mfu)


def model_flops_for(cfg, shape_cfg) -> float:
    """6*N*D tokens rule: train counts fwd+bwd (6ND); prefill counts 2ND;
    decode counts 2N per generated token (D = tokens processed)."""
    n = cfg.n_active_params()
    tokens = shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "train":
        return 6.0 * n * tokens
    if shape_cfg.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one new token per sequence in the batch
    return 2.0 * n * shape_cfg.global_batch
