"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060], the port of
``models/ssm.py``.

Chunked SSD: within a chunk of length Q the output is a masked product
(``kernels.ssd_scan.ssd_intra``: the hand-written CUDA kernel on the card,
its plain version for CPU tensors); across chunks a loop carries the
(H, P, N) state. ``ssd_ref`` (the naive recurrence) is the oracle.

Shapes: x (B,S,H,P) head-split inner activations; dt (B,S,H); A (H,);
B/C (B,S,G,N) with G groups broadcast over heads (head h reads group
h // (H/G)).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_intra, ssd_intra_plain
from .layers import rmsnorm


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor] = None,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential recurrence (the oracle).

    h_t = exp(A dt_t) * h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t + D x_t
    Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    Bh = B.float().repeat_interleave(rep, dim=2)    # (B,S,H,N)
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(A.float()[None, None] * dtf)  # (B,S,H)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                D: Optional[torch.Tensor] = None,
                init_state: Optional[torch.Tensor] = None, chunk: int = 256,
                use_kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the intra-chunk terms from ``ssd_intra`` (the kernel
    with ``use_kernel=True``; ``use_kernel=False`` calls the plain version
    on any device), then the recurrence over the chunk states, the
    inter-chunk term and the ``D`` skip in plain PyTorch."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = -s % chunk
    xp, dtp, Bp, Cp = x, dt, B, C
    if pad:
        xp = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(B, (0, 0, 0, 0, 0, pad))
        Cp = F.pad(C, (0, 0, 0, 0, 0, pad))
    s_pad = s + pad
    nc, q, rep = s_pad // chunk, chunk, h // g

    xc = xp.float().reshape(b, nc, q, h, p).contiguous()
    dtc = dtp.float().reshape(b, nc, q, h).contiguous()
    Bc = Bp.float().reshape(b, nc, q, g, n).contiguous()
    Cc = Cp.float().reshape(b, nc, q, g, n).contiguous()
    a = A.float().contiguous()
    intra = ssd_intra if use_kernel else ssd_intra_plain
    y_intra, states, decay = intra(xc, dtc, a, Bc, Cc)

    # inter-chunk recurrence over nc chunks (sequential, tiny): the state
    # entering each chunk, and the final state
    s_in = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if init_state is None else init_state.float())
    prev = []
    for ci in range(nc):
        prev.append(s_in)
        s_in = s_in * decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)             # (b,nc,h,p,n)

    # inter-chunk contribution: C_t . exp(cs_t) . state entering the chunk,
    # per group (no repeat of C over the heads)
    cs = torch.cumsum(a * dtc, dim=2)                  # (b,nc,q,h)
    y_inter = torch.einsum(
        "bctgn,bcgrpn->bctgrp", Cc, prev_states.reshape(
            b, nc, g, rep, p, n)) * torch.exp(cs).reshape(
                b, nc, q, g, rep, 1)
    y = (y_intra + y_inter.reshape(b, nc, q, h, p)).reshape(
        b, s_pad, h, p)[:, :s]
    if D is not None:
        y = y + D[None, None, :, None] * x.float()
    return y.to(x.dtype), s_in


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    D: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state (B,H,P,N); x (B,H,P); dt (B,H);
    B/C (B,G,N). Returns (y (B,H,P), new_state)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    Bh = B.float().repeat_interleave(rep, dim=1)
    Ch = C.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(A.float()[None] * dt.float())
    state = state * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt.float(), Bh, x.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    if D is not None:
        y = y + D[None, :, None] * x.float()
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def causal_conv1d(u: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u (B,S,Cdim); w (Cdim, Kw). Returns (y, new
    conv state (B, Cdim, Kw-1))."""
    bsz, s, cdim = u.shape
    kw = w.shape[1]
    if state is None:
        state = torch.zeros((bsz, cdim, kw - 1), dtype=u.dtype,
                            device=u.device)
    upad = torch.cat([state.transpose(1, 2), u], dim=1)  # (B, S+kw-1, Cdim)
    y = torch.zeros((bsz, s, cdim), dtype=torch.float32, device=u.device)
    for i in range(kw):
        y = y + upad[:, i:i + s].float() * w[:, i].float()
    new_state = (upad[:, -(kw - 1):].transpose(1, 2).contiguous() if kw > 1
                 else state)
    return F.silu(y).to(u.dtype), new_state


def _conv_step(u_t: torch.Tensor, w: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token depthwise conv. u_t (B,Cdim); state (B,Cdim,Kw-1)."""
    kw = w.shape[1]
    full = torch.cat([state, u_t[..., None]], dim=-1)  # (B,Cdim,Kw)
    y = (full.float() * w[None].float()).sum(-1)
    return F.silu(y).to(u_t.dtype), (full[..., 1:].contiguous() if kw > 1
                                     else state)


def mamba2_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 decode: bool = False, use_kernel: bool = True):
    """x (B,S,D). Params: w_in (D, 2*I+2*G*N+H), conv_w (I+2GN, Kw),
    A_log (H,), D (H,), dt_bias (H,), norm (I,), w_out (I, D).
    ``use_kernel`` picks the SSD intra-chunk kernel (default) or its plain
    version for the prefill; decode runs no kernel.

    Returns (y (B,S,D), (new_ssm_state, new_conv_state))."""
    s = cfg.ssm
    bsz, slen, d = x.shape
    inner = s.expand * d
    nheads = inner // s.head_dim
    gn = s.n_groups * s.d_state

    zxbcdt = torch.einsum("bsd,de->bse", x, p["w_in"])
    z, xbc, dt = torch.split(zxbcdt, [inner, inner + 2 * gn, nheads], dim=-1)

    if decode:
        y_conv, conv_state = _conv_step(xbc[:, 0], p["conv_w"], conv_state)
        y_conv = y_conv[:, None]
    else:
        y_conv, conv_state = causal_conv1d(xbc, p["conv_w"], conv_state)
    xs, B, C = torch.split(y_conv, [inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, slen, nheads, s.head_dim)
    B = B.reshape(bsz, slen, s.n_groups, s.d_state)
    C = C.reshape(bsz, slen, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if decode:
        y1, ssm_state = ssd_decode_step(
            ssm_state, xs[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], p["D"])
        y1 = y1[:, None]
    else:
        y1, ssm_state = ssd_chunked(xs, dt, A, B, C, p["D"],
                                    init_state=ssm_state, chunk=s.chunk,
                                    use_kernel=use_kernel)
    y1 = y1.reshape(bsz, slen, inner)
    # gated RMSNorm (mamba2's norm-before-out-proj, gated by z)
    y1 = rmsnorm(y1 * F.silu(z), p["norm"], cfg.rmsnorm_eps)
    y = torch.einsum("bsi,id->bsd", y1, p["w_out"])
    return y, (ssm_state, conv_state)
