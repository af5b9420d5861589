#!/usr/bin/env python3
"""Time the paged-attention and SSD kernels of two checkouts on one card
with one harness: the ``_time_ms`` of this checkout's ``chip_smoke.py``.

    python3 tools/kernel_ab.py OTHER      # from the repository root

OTHER is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into the git-ignored ``build/``. Each
reading runs in a process of its own that imports that tree's
``repro_torch`` and builds its kernels, in the order OTHER, this, this,
OTHER, so that a drift of the card during the run shows as a gap between
a tree's two readings. A process times each kernel at a shape that
``chip_smoke.py`` times it at, on inputs made from a seed, after holding
the kernel's output against that tree's own plain version:

* paged attention at the qwen3_4b decode step's shape: q (4, 32, 128), a
  (257, 16, 8, 128) page pool, a (4, 64) block table, contexts
  [473, 149, 363, 577];
* paged attention at S = 8, contexts [0, 1, 15, 16, 17, 300, 1000, 2047];
* ``ssd_intra`` at the shape of layer 0 of the (4, 675) mamba2_780m
  prefill: x (4, 3, 256, 48, 64), B/C (4, 3, 256, 1, 128), A = -1.

Prints each reading, a table, and last one JSON object of all readings.
Needs one card; exits with another code than 0 if a reading fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("paged main", "paged S=8", "ssd_intra")


def _inputs(cs):
    """The three cases' inputs, from ``chip_smoke.py``'s makers."""
    import numpy as np
    import torch
    rng = np.random.default_rng(cs.SEED)
    main = cs._paged_case(rng, s_n=4, h=32, kv=8, dh=128, page=16,
                          n_pages_pool=257, ctx_lens=[473, 149, 363, 577])
    # the engine's block table has a column for every page a lane may hold
    bt = torch.zeros((4, cs.MAX_PAGES_PER_SEQ), dtype=torch.int32,
                     device="cuda")
    bt[:, :main[3].shape[1]] = main[3]
    main[3] = bt
    s8 = cs._paged_case(np.random.default_rng(cs.SEED + 1), s_n=8, h=32,
                        kv=8, dh=128, page=16, n_pages_pool=520,
                        ctx_lens=[0, 1, 15, 16, 17, 300, 1000, 2047])
    ssd = cs._ssd_case(rng, b=4, nc=3, q=256, h=48, p=64, g=1, n=128,
                       a=-1.0)
    return dict(zip(CASES, (main, s8, ssd)))


def reading(tree: Path) -> dict:
    """Times the kernels of ``tree`` in this process."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ on sys.path
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA card")
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            (tree / "src").resolve()):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}")
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fns = {"paged main": (paged_attention, paged_attention_plain),
           "paged S=8": (paged_attention, paged_attention_plain),
           "ssd_intra": (ssd_intra, ssd_intra_plain)}
    out = {"tree": str(tree)}
    for name, case in _inputs(cs).items():
        fn, plain = fns[name]
        got, want = fn(*case), plain(*case)
        if name == "ssd_intra":  # chip_smoke's full-width limit
            ok = all(torch.all((g - w).abs() <= cs.KERNEL_TOL * (
                w.abs().max() + w.abs())).item() for g, w in zip(got, want))
        else:
            ok = (got - want).abs().max().item() <= cs.KERNEL_TOL
        if not ok:
            raise AssertionError(f"{tree}: {name} disagrees with its plain "
                                 f"version")
        out[name] = cs._time_ms(lambda: fn(*case), flush)
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        print(json.dumps(reading(Path(sys.argv[2]).resolve())))
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    other = Path(sys.argv[1]).resolve()
    runs = []
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"kernel_ab: the reading of {tree} failed:\n"
                     f"{proc.stdout}{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"reading {len(runs)} ({tree}): " + ", ".join(
            f"{c} {runs[-1][c]:.4f} ms" for c in CASES))
    for c in CASES:
        o = (runs[0][c] + runs[3][c]) / 2
        t = (runs[1][c] + runs[2][c]) / 2
        print(f"{c}: other {runs[0][c]:.4f}/{runs[3][c]:.4f} ms, this "
              f"{runs[1][c]:.4f}/{runs[2][c]:.4f} ms, other/this {o / t:.2f}")
    print(json.dumps({"readings": runs}))


if __name__ == "__main__":
    main()
