"""Mamba2 (SSD) block — chunked selective state-space layer (Zamba2 backbone).

Ports ``repro.models.mamba2`` for one device.  The reference's ``lax.scan``
over sequence chunks is a Python loop here: each chunk's intra-chunk
lower-triangular product, the carried state's contribution and the state
update, in that order and in float32.  No Pallas kernel computes any of it
in the reference, so torch ops are the whole port.

Shapes follow the Mamba2 paper: d_inner = expand·d, heads = d_inner/head_dim,
scalar decay A per head, grouped B/C (n_groups).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import DP, leaf, rms_norm


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    conv_ch = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_ch


def mamba2_template(cfg: ArchConfig) -> Dict:
    s, di, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    return {
        # [z (di), xBC (di + 2*G*N), dt (nh)]
        "w_in": leaf((d, 2 * di + 2 * s.n_groups * s.d_state + nh), (None, "model")),
        "conv_w": leaf((s.d_conv, conv_ch), (None, "model"), scale=0.5),
        "conv_b": leaf((conv_ch,), ("model",), init="zeros"),
        "dt_bias": leaf((nh,), ("model",), init="zeros"),
        "a_log": leaf((nh,), ("model",), init="ones"),
        "d_skip": leaf((nh,), ("model",), init="ones"),
        "norm_w": leaf((di,), ("model",), init="ones"),
        "w_out": leaf((di, d), ("model", None)),
    }


def mamba2_state_template(cfg: ArchConfig, batch: int) -> Dict:
    s, di, nh, conv_ch = _dims(cfg)
    return {
        "ssm": leaf((batch, nh, s.head_dim, s.d_state), (DP, "model", None, None), init="zeros"),
        "conv": leaf((batch, s.d_conv - 1, conv_ch), (DP, None, "model"), init="zeros"),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    s, di, nh, conv_ch = _dims(cfg)
    return zxbcdt[..., :di], zxbcdt[..., di:di + conv_ch], zxbcdt[..., di + conv_ch:]


def _causal_conv(xbc, conv_w, conv_b, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time, then SiLU.  xbc: (B, S, C); conv_w:
    (W, C); conv_state: the previous W - 1 inputs (B, W - 1, C) or None
    (zeros).  Returns the output and the new conv state."""
    W = conv_w.shape[0]
    pad = (torch.zeros((xbc.shape[0], W - 1, xbc.shape[-1]), dtype=xbc.dtype,
                       device=xbc.device) if conv_state is None else conv_state)
    xp = torch.cat([pad, xbc], dim=1)                   # (B, S+W-1, C)
    out = sum(xp[:, i:i + xbc.shape[1]] * conv_w[i] for i in range(W))
    out = F.silu(out + conv_b)
    return out, (xp[:, -(W - 1):] if W > 1 else pad)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    x:  (B, S, nh, hd)    dt: (B, S, nh)   A: (nh,) (negative)
    Bm/Cm: (B, S, G, N);  heads are grouped G | nh.
    Returns y (B, S, nh, hd) and the final state (B, nh, hd, N), float32.
    S is zero-padded to a multiple of the chunk, as the reference pads it.
    """
    Bsz, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    L = min(chunk, S)
    nchunk = -(-S // L)
    pad = nchunk * L - S
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    h = (torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nchunk):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dtc * A[None, None, :]                         # (B,L,nh) negative
        cum = torch.cumsum(dA, dim=1)                       # (B,L,nh)
        Bh = Bc.repeat_interleave(rep, dim=2)               # (B,L,nh,N)
        Ch = Cc.repeat_interleave(rep, dim=2)
        # intra-chunk: attention-like lower-triangular matrix
        scores = torch.einsum("blhn,bshn->bhls", Ch, Bh)    # (B,nh,L,L)
        cum_h = cum.permute(0, 2, 1)                        # (B,nh,L)
        decay = cum_h[:, :, :, None] - cum_h[:, :, None, :]  # cum[l] - cum[s]
        # exp overflows above the diagonal: select, never multiply by the mask
        w = torch.where(mask, torch.exp(decay), 0.0) * scores
        xdt = xc * dtc[..., None]                           # (B,L,nh,hd)
        y_intra = torch.einsum("bhls,bshd->blhd", w, xdt)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("blhn,bhdn->blhd", Ch * torch.exp(cum)[..., None], h)
        # state update
        tail = torch.exp(cum[:, -1:, :] - cum)              # (B,L,nh)
        chunk_state = torch.einsum("bshd,bshn->bhdn", xdt * tail[..., None], Bh)
        h = h * torch.exp(dA.sum(1))[:, :, None, None] + chunk_state
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba2_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                 state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d).  With ``state``: single-step decode (S
    should be 1), returning the new recurrent and conv state."""
    s, di, nh, conv_ch = _dims(cfg)
    B, S, d = x.shape
    z, xbc, dt = _split_proj(cfg, x @ p["w_in"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    GN = s.n_groups * s.d_state
    xs = xbc[..., :di].reshape(B, S, nh, s.head_dim)
    Bm = xbc[..., di:di + GN].reshape(B, S, s.n_groups, s.d_state)
    Cm = xbc[..., di + GN:].reshape(B, S, s.n_groups, s.d_state)

    if state is None:
        y, _ = _ssd_chunked(xs, dt, A, Bm, Cm, s.chunk)
        new_state = None
    else:
        # single-step recurrence: h = h*exp(dt*A) + dt*B x ; y = C·h
        h = state["ssm"].float()                            # (B,nh,hd,N)
        rep = nh // s.n_groups
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1).float()  # (B,nh,N)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1).float()
        dt0 = dt[:, 0]                                      # (B,nh)
        xdt = xs[:, 0].float() * dt0[..., None]             # (B,nh,hd)
        h = h * torch.exp(dt0 * A)[:, :, None, None] + torch.einsum("bhd,bhn->bhdn", xdt, Bh)
        y = torch.einsum("bhdn,bhn->bhd", h, Ch)[:, None]
        new_state = {"ssm": h, "conv": new_conv}
    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"], new_state
