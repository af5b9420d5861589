"""Flash attention forward: the hand-written CUDA kernel and its plain
PyTorch version, on the model's layout.

``flash_mha(q, k, v)`` takes q (B, Sq, H, Dh) and k/v (B, Sk, Kv, Dh), as
the reference's ``ops.flash_mha`` does; query head ``h`` attends kv head
``h // (H / Kv)``. The causal mask is index-based (key ``k`` visible to
query ``q`` when ``k <= q``, also when Sq != Sk), the window keeps
``k > q - window``, the softcap ``tanh(s / c) * c`` comes before the mask.
It launches the kernel in ``csrc/flash_attention.cu`` (replacing the
reference's Pallas ``_flash_kernel``) for CUDA tensors and takes
``flash_mha_plain`` only for CPU tensors; on the card it launches or
raises, it never falls back. On the meta device (the dry-run,
``launch.dryrun``) it checks the kernel's limits and returns the empty
meta output. ``flash_mha.launches`` counts the kernel launches. The kernel takes head dims up to 256, as the reference (which
pads any head dim to a multiple of 128) does, and reads q/k/v by their
strides; an input whose head dim is not unit-stride is copied first.

Both follow ``ref.mha_ref`` where the Pallas kernel does not: keys past
Sk never enter the softmax (the Pallas kernel, not causal and with Sk not
a multiple of its block, lets its zero pad keys in). A query row that sees
no key (Sq > Sk with a window) gives 0 in both, where ``mha_ref`` gives
NaN.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import cuda_lib
from ..models import layers

# the kernel's limits: head_dim up to 256 (zero-padded to 64, 128 or 256 in
# shared memory); one thread block per (tile of 64 or 128 packed query rows
# (position, head of the kv head's group), kv head, batch row), the packed
# rows and the blocks counted in 32-bit ints
MAX_HEAD_DIM = 256
MAX_INT32 = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_lib.load("flash_attention").flash_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(head_dim: int) -> int:
    """Thread blocks of the kernel built for ``head_dim`` that one SM of
    the current card holds at once (its registers and shared memory)."""
    fn = cuda_lib.load("flash_attention").flash_attention_f32_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = fn(head_dim, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"flash_mha occupancy query failed: CUDA error "
                           f"{rc}")
    return n.value


def _check(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_mha needs q (B,Sq,H,Dh) and k/v "
                         f"(B,Sk,Kv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, sq, h, dh = q.shape
    kv = k.shape[2]
    if k.shape[0] != bsz or k.shape[3] != dh or kv == 0 or h % kv:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k/v {tuple(k.shape)}"
                         f" (batch and head_dim must agree, Kv divide H)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    rows = sq * (h // kv)
    if not (0 < dh <= MAX_HEAD_DIM and rows <= MAX_INT32
            and -(-rows // 64) * kv * bsz <= MAX_INT32):
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"fewer than 2**31 packed rows and thread blocks; "
                         f"got head_dim {dh}, q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward. q (B,Sq,H,Dh); k/v (B,Sk,Kv,Dh), Kv dividing H,
    Dh <= 256; fp32, any strides. Returns (B,Sq,H,Dh), contiguous.
    ``scale`` defaults to 1/sqrt(Dh)."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_mha: no kernel for {q.device}")
    _check(q, k, v, window, softcap)
    # the kernel copies rows of Dh contiguous floats
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    bsz, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((bsz, sq, h, dh), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0 or q.device.type == "meta":  # meta: the dry-run
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    # a window that reaches past every key masks nothing (the model passes
    # INF_WINDOW = 2**30 for "no window"); the kernel takes it as 0 = none
    win = 0 if window is None or window >= sq + sk else int(window)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bsz, sq, sk, h, kv, dh, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], int(causal), win, float(scale),
                float(softcap or 0.0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_mha kernel launch failed: CUDA error {rc}")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: the model's ``attention_ref`` at positions
    ``arange(Sq)`` and ``arange(Sk)``, where its mask is the index-based one
    of ``ref.mha_ref``. A row that sees no key gives 0, as in the kernel
    (``mha_ref``'s softmax gives NaN there)."""
    bsz, sq = q.shape[:2]
    sk = k.shape[1]
    pos_q = torch.arange(sq, device=q.device).expand(bsz, sq)
    pos_k = torch.arange(sk, device=q.device).expand(bsz, sk)
    o = layers.attention_ref(q, k, v, pos_q=pos_q, pos_k=pos_k,
                             causal=causal, window=window, softcap=softcap,
                             scale=scale)
    seen = torch.isfinite(layers._mask_bias(pos_q, pos_k, causal,
                                            window)).any(-1)
    return o.masked_fill(~seen[:, :, None, None], 0.0)
