"""Paged decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

One query token per sequence attends to K/V that live in a page pool
(``serving/kv_pool.py``), reached through per-sequence block tables.
``paged_attention`` launches the kernel in ``csrc/paged_attention.cu``
(replacing the reference's Pallas ``_paged_kernel``) for CUDA tensors and
takes ``paged_attention_plain`` only for CPU tensors; on the card it
launches or raises, it never falls back. The kernel splits each
sequence's keys over blocks and merges their partials in a second pass
(``_split_plan`` picks the split from shapes alone); both passes launch
from one call. ``paged_attention.launches`` counts calls that launched
the kernel, one per attention: a decode step of the continuous engine
adds one per layer (36 for ``qwen3_4b``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import cuda_lib

NEG_INF = -1e30
# the kernel's limits and tiling: keys a block holds at once, query heads
# of one kv head a block serves, and blocks per SM to aim the split at.
# The first three mirror csrc/paged_attention.cu's kMaxHeadDim, kTileKeys
# and kMaxHeads, whose entry point refuses a launch that breaks them.
MAX_HEAD_DIM = 256
TILE_KEYS = 32
MAX_HEADS_PER_BLOCK = 16
BLOCKS_PER_SM = 16


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_lib.load("paged_attention").paged_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, context_lens, softcap):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (S,H,Dh) and k_pages (P,page,Kv,Dh); "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    s_n, h, dh = q.shape
    _, _, kv, dh_k = k_pages.shape
    if v_pages.shape != k_pages.shape or dh_k != dh or h % kv:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != s_n \
            or tuple(context_lens.shape) != (s_n,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match {s_n} sequences")
    for name, t, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("block_tables", block_tables, torch.int32),
                        ("context_lens", context_lens, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    # the kernel moves K/V rows as 16-byte vectors and holds a 32-key tile
    # of K and V for up to 16 query heads in shared memory
    if dh % 4 or dh > MAX_HEAD_DIM or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError(f"the kernel needs head_dim % 4 == 0, head_dim <= "
                         f"{MAX_HEAD_DIM} and 16-byte aligned pages; got "
                         f"head_dim {dh}")


@functools.lru_cache(maxsize=256)
def _split_plan(s_n: int, kv: int, rep: int, max_keys: int,
                n_sm: int) -> Tuple[int, int, int]:
    """How the kernel splits the work, from shapes alone (never from
    ``context_lens``, which lives on the card): ``(hb, chunk, n_splits)``.

    ``hb`` query heads of a kv head share a block (at most 16, groups as
    even as they can be). The ``max_keys`` keys the block table can reach
    are cut into ``n_splits`` chunks of ``chunk`` keys (a multiple of 32),
    as many as bring the grid to ``BLOCKS_PER_SM`` blocks an SM, one
    32-key tile a block at the least."""
    n_hg = -(-rep // MAX_HEADS_PER_BLOCK)
    hb = -(-rep // n_hg)
    n_tiles = max(1, -(-max_keys // TILE_KEYS))
    want = -(-BLOCKS_PER_SM * n_sm // (s_n * kv * n_hg))
    tiles_per_split = -(-n_tiles // max(1, min(want, n_tiles)))
    return hb, TILE_KEYS * tiles_per_split, -(-n_tiles // tiles_per_split)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention.

    q:               (S, H, Dh) fp32, one query token per sequence
    k_pages/v_pages: (P, page_size, Kv, Dh) fp32 physical page pool
    block_tables:    (S, n_pages) int32 logical->physical page map (unused
                     slots point at a valid page, e.g. 0)
    context_lens:    (S,) int32 tokens of context (0 = inactive lane; its
                     output row is exactly 0)
    Returns (S, H, Dh). Query head ``j*rep + r`` reads kv head ``j``.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens, scale=scale,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens, softcap)
    s_n, h, dh = q.shape
    _, page, kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    if s_n == 0:
        return out
    n_pages = block_tables.shape[1]
    hb, chunk, n_splits = _split_plan(s_n, kv, h // kv, n_pages * page,
                                      cuda_lib.n_sm(q.device))
    # scratch: each split's (m, l), then its acc[Dh], per (sequence, query
    # head)
    part = torch.empty(s_n * h * n_splits * (dh + 2), dtype=torch.float32,
                       device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), part.data_ptr(),
                part.data_ptr() + 4 * (s_n * h * n_splits * 2),
                s_n, h, kv, dh, page, n_pages, chunk, n_splits, hb,
                float(scale), float(softcap or 0.0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          context_lens: torch.Tensor, *,
                          scale: Optional[float] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version (the reference's ``paged_attention_ref``): gather the
    pages into dense per-sequence K/V, masked softmax in fp32. Same
    contract as ``paged_attention``."""
    s_n, h, dh = q.shape
    _, page, kv, _ = k_pages.shape
    rep = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    bt = block_tables.long()
    k = k_pages[bt].reshape(s_n, -1, kv, dh)          # (S, n_ctx, Kv, Dh)
    v = v_pages[bt].reshape(s_n, -1, kv, dh)
    kx = k.repeat_interleave(rep, dim=2)              # (S, n_ctx, H, Dh)
    vx = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("shd,snhd->shn", q.float() * scale, kx.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, :]
            < context_lens[:, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shn,snhd->shd", p, vx.float())
    o = torch.where((context_lens > 0)[:, None, None], o, 0.0)
    return o.to(q.dtype)
