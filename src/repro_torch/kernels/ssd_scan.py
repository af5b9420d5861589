"""Mamba2 SSD intra-chunk terms: the hand-written CUDA kernel and its plain
PyTorch version.

Per (batch, chunk, head), with ``cs = cumsum(dt * a)`` along the chunk:

* ``y_intra[t] = sum_{u<=t} (C_t . B_u) exp(cs_t - cs_u) dt_u x_u``;
* ``states = sum_u exp(cs_last - cs_u) dt_u x_u B_u^T``, (P, N) per head;
* ``decay = exp(cs_last)``.

``ssd_intra`` launches the kernel in ``csrc/ssd_scan.cu`` (replacing the
reference's Pallas ``_ssd_kernel``) for CUDA tensors and takes
``ssd_intra_plain`` only for CPU tensors; on the card it launches or
raises, it never falls back. On the meta device (the dry-run,
``launch.dryrun``) it checks the kernel's limits and returns empty meta
tensors of the outputs' shapes. ``ssd_intra.launches`` counts the kernel
launches: one per call, whatever the head dim (48 per prefill of
``mamba2_780m``).

Any head dim: every output's head-dim column depends on x's column alone,
so the kernel covers ``P`` in blocks of ``P_BLOCK`` columns, each block
reading x and writing y at their own row stride (nothing is copied).

B and C come per group, ``(B, NC, Q, G, N)``, and head ``h`` reads group
``h // (H / G)``; for ``G = H`` this is the reference's signature. The
kernel reads each group once; the plain version repeats B and C over the
heads, as the reference's ``ssd_chunked`` does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_lib

# head-dim columns a block covers (csrc/ssd_scan.cu's kT); a larger P runs
# ceil(P / P_BLOCK) blocks for each piece of work
P_BLOCK = 64
# the wrapper's limits: a (64 x P_BLOCK) tile of x, C and B staged 32
# columns of N at a time, cs of a block's heads over the chunk in shared
# memory; they keep the block's shared memory within the card's.
MAX_D_STATE = 256
MAX_CHUNK = 4096
# heads a y-block serves at most, and the floats their cs and dt arrays
# may take in shared memory (the chunk's length each, twice)
MAX_HEADS_PER_BLOCK = 8
CS_FLOATS = 8192


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_lib.load("ssd_scan").ssd_intra_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, a, b, c) -> None:
    if x.dim() != 5 or dt.dim() != 4 or a.dim() != 1 or b.dim() != 5:
        raise ValueError(f"ssd_intra needs x (B,NC,Q,H,P), dt (B,NC,Q,H), "
                         f"a (H,), b/c (B,NC,Q,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    if tuple(dt.shape) != (bsz, nc, q, h) or tuple(a.shape) != (h,) \
            or tuple(b.shape[:3]) != (bsz, nc, q) or c.shape != b.shape \
            or g == 0 or h % g:
        raise ValueError(f"shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" a {tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} (G must divide H)")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (0 < n <= MAX_D_STATE and 0 < q <= MAX_CHUNK):
        raise ValueError(f"the kernel takes d_state <= {MAX_D_STATE} and "
                         f"chunk <= {MAX_CHUNK}; got N {n}, Q {q}")


def _block_plan(bnc: int, q: int, h: int, g: int, p: int, n: int,
                n_sm: int) -> Tuple[int, int]:
    """How the kernel cuts the work, from shapes: ``(hb, top_levels)``.

    A y-block serves ``hb`` heads of one group (at most 8, and as many as
    the cs and dt arrays of a chunk fit in ``CS_FLOATS``), halved while
    the y-blocks alone would not fill two blocks an SM. Of the query-tile
    levels, the ``top_levels`` longest (whose blocks do at least a state
    block's work) run before the state blocks, the rest after them. Every
    block covers at most ``P_BLOCK`` head-dim columns, and each piece of
    work runs ``ceil(p / P_BLOCK)`` blocks."""
    hg, n_qt = h // g, -(-q // 64)
    n_pb, pw = -(-p // P_BLOCK), min(p, P_BLOCK)
    ld = (q + 2) & ~1
    hb = max(1, min(hg, MAX_HEADS_PER_BLOCK, CS_FLOATS // (2 * ld)))
    while hb > 1 and n_qt * -(-hg // hb) * g * bnc * n_pb < 2 * n_sm:
        hb = (hb + 1) // 2
    state_work = q * pw * n
    top = sum((qt + 1) * 64 * 64 * (n + hb * pw) >= state_work
              for qt in range(n_qt))
    return hb, top


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SSD intra-chunk terms.

    x (B,NC,Q,H,P); dt (B,NC,Q,H); a (H,); b/c (B,NC,Q,G,N), G divides H;
    all fp32. Returns (y_intra (B,NC,Q,H,P), states (B,NC,H,P,N),
    decay (B,NC,H)).
    """
    if x.device.type == "cpu":
        return ssd_intra_plain(x, dt, a, b, c)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_intra: no kernel for {x.device}")
    _check(x, dt, a, b, c)
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    y = torch.empty_like(x)
    states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or x.device.type == "meta":  # meta: the dry-run
        return y, states, decay
    hb, top = _block_plan(bsz * nc, q, h, g, p, n, cuda_lib.n_sm(x.device))
    vec = (p % 4 == 0 and n % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, b, c, y, states)))
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), states.data_ptr(),
                decay.data_ptr(), bsz * nc, q, h, p, g, n, hb, top, int(vec),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra kernel launch failed: CUDA error "
                           f"{rc}")
    ssd_intra.launches += 1
    return y, states, decay


ssd_intra.launches = 0


def ssd_intra_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version (the reference's ``ref.ssd_intra_ref`` and the
    intra-chunk part of ``ssd_chunked``): B and C repeated over the heads,
    the full (Q, Q) segment-decay matrix with its upper triangle set to 0.
    The upper triangle's segment sums are masked to ``-inf`` before the
    ``exp``, where the reference masks the ``exp`` after taking it: the
    forward is the same to the bit, and the gradient stays finite where
    ``exp`` of an unmasked upper-triangle sum (up to ~177 for a chunk of
    256 at ``A = -1``) would overflow to ``inf`` and its backward give
    0 * inf = NaN. Same contract as ``ssd_intra``."""
    h = x.shape[3]
    rep = h // b.shape[3]
    x, dt, a = x.float(), dt.float(), a.float()
    bh = b.float().repeat_interleave(rep, dim=3)      # (B,NC,Q,H,N)
    ch = c.float().repeat_interleave(rep, dim=3)
    q = x.shape[2]
    cs = torch.cumsum(dt * a, dim=2)                  # (B,NC,Q,H)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,NC,Qt,Qu,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], seg, -torch.inf))
    cb = torch.einsum("bcthn,bcuhn->bctuh", ch, bh)
    y = torch.einsum("bctuh,bcuh,bcuhp->bcthp", cb * L, dt, x)
    d_end = torch.exp(cs[:, :, -1:, :] - cs)
    states = torch.einsum("bcuh,bcuh,bcuhn,bcuhp->bchpn", d_end, dt, bh, x)
    decay = torch.exp(cs[:, :, -1, :])
    return y, states, decay
