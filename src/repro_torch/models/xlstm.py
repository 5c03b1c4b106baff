"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, step recurrence).  [arXiv:2405.04517]

Ports ``repro.models.xlstm`` for one device.  The mLSTM keeps the
reference's exact stabilised recurrence in chunked form; its ``lax.scan``
over chunks is a Python loop here.  The sLSTM is a per-token recurrence
(``lax.scan`` over S in the reference), so it is a Python loop over the
sequence: a prompt of S tokens runs S small steps one after another.  No
Pallas kernel computes any of it in the reference, so torch ops are the
whole port.

State per mLSTM head: (C: dk×dv matrix memory, n: dk normaliser, m: scalar
max-stabiliser), stored as Ĉ, n̂ with true value Ĉ·exp(m).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import DP, leaf, rms_norm
# the mLSTM's conv is the same arithmetic as the Mamba2 block's (the
# reference keeps two copies of it)
from .mamba2 import _causal_conv

_NEG = -1e30   # the stabiliser's start ("-inf" that stays finite)


def _mdims(cfg: ArchConfig):
    xc = cfg.xlstm
    di = int(cfg.d_model * xc.proj_factor)
    nh = cfg.n_heads
    dk = di // nh
    return xc, di, nh, dk


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_template(cfg: ArchConfig) -> Dict:
    xc, di, nh, dk = _mdims(cfg)
    d = cfg.d_model
    return {
        "w_up": leaf((d, 2 * di), (None, "model")),        # [x_inner, z-gate]
        "conv_w": leaf((xc.conv_width, di), (None, "model"), scale=0.5),
        "conv_b": leaf((di,), ("model",), init="zeros"),
        "wq": leaf((di, di), (None, "model")),
        "wk": leaf((di, di), (None, "model")),
        "wv": leaf((di, di), (None, "model")),
        "w_if": leaf((di, 2 * nh), (None, "model")),       # input/forget gate logits
        "b_if": leaf((2 * nh,), ("model",), init="zeros"),
        "norm_w": leaf((di,), ("model",), init="ones"),
        "w_down": leaf((di, d), ("model", None)),
    }


def mlstm_state_template(cfg: ArchConfig, batch: int) -> Dict:
    xc, di, nh, dk = _mdims(cfg)
    return {
        "C": leaf((batch, nh, dk, dk), (DP, "model", None, None), init="zeros"),
        "n": leaf((batch, nh, dk), (DP, "model", None), init="zeros"),
        # the max-stabiliser starts at -1e30, as the chunked prefill does
        "m": leaf((batch, nh), (DP, "model"), init="full", scale=_NEG),
        "conv": leaf((batch, xc.conv_width - 1, di), (DP, None, "model"), init="zeros"),
    }


def _chunked_mlstm(q, k, v, ig, fg, chunk: int, state=None):
    """Stabilised chunkwise mLSTM.

    q/k/v: (B, S, nh, dk); ig/fg: (B, S, nh) raw gate logits; state: (C, n,
    m) float32 or None.  Returns h (B, S, nh, dk) and the final (C, n, m).
    S is padded to a multiple of the chunk, the forget logits with -30.
    """
    B, S, nh, dk = q.shape
    L = min(chunk, S)
    nchunk = -(-S // L)
    pad = nchunk * L - S
    q, k, v, ig, fg = q.float(), k.float(), v.float(), ig.float(), fg.float()
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad))
        fg = F.pad(fg, (0, 0, 0, pad), value=-30.0)
    dev = q.device
    if state is None:
        C = torch.zeros((B, nh, dk, dk), dtype=torch.float32, device=dev)
        n = torch.zeros((B, nh, dk), dtype=torch.float32, device=dev)
        m = torch.full((B, nh), _NEG, dtype=torch.float32, device=dev)
    else:
        C, n, m = state
    scale = dk ** -0.5
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None, :, :, None]
    hs = []
    for c in range(nchunk):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]
        a, g = ig[:, sl], F.logsigmoid(fg[:, sl])           # input logits, log-forget
        Bcum = torch.cumsum(g, dim=1)                       # (B,L,nh)
        # weight(t,s) = B_t - B_s + a_s  (s's own input is not decayed);
        # per-position stabiliser m_t = max(m_prev + B_t, B_t + max_{s<=t}(a_s - B_s))
        run_max = torch.cummax(a - Bcum, dim=1).values
        m_t = torch.maximum(m[:, None] + Bcum, run_max + Bcum)
        logw = (Bcum[:, :, None, :] - Bcum[:, None, :, :]
                + a[:, None, :, :] - m_t[:, :, None, :])
        # exp overflows above the diagonal: select, never multiply by the mask
        w = torch.where(mask, torch.exp(logw), 0.0)         # (B,L,L,nh)
        scores = torch.einsum("blhd,bshd->blsh", qc, kc) * scale
        inter = torch.exp(m[:, None] + Bcum - m_t)          # (B,L,nh)
        ws = w * scores
        num = (torch.einsum("blsh,bshd->blhd", ws, vc)
               + torch.einsum("blhd,bhde->blhe", qc * scale * inter[..., None], C))
        den = ws.sum(2) + torch.einsum("blhd,bhd->blh", qc * scale, n) * inter
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # end-of-chunk state
        BL = Bcum[:, -1, :]                                 # (B,nh)
        m_new = torch.maximum(m + BL, run_max[:, -1] + BL)
        tailw = torch.exp(BL[:, None] - Bcum + a - m_new[:, None])
        decay = torch.exp(m + BL - m_new)
        C = (C * decay[:, :, None, None]
             + torch.einsum("bshd,bshe->bhde", kc * tailw[..., None], vc))
        n = n * decay[:, :, None] + (kc * tailw[..., None]).sum(1)
        m = m_new
    return torch.cat(hs, dim=1)[:, :S], (C, n, m)


def mlstm_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d).  With ``state`` (C, n, m, conv): returns
    the new state too."""
    xc, di, nh, dk = _mdims(cfg)
    B, S, d = x.shape
    up = x @ p["w_up"]
    inner, z = up[..., :di], up[..., di:]
    conv_state = state["conv"] if state is not None else None
    cx, new_conv = _causal_conv(inner, p["conv_w"], p["conv_b"], conv_state)
    q = (cx @ p["wq"]).reshape(B, S, nh, dk)
    k = (cx @ p["wk"]).reshape(B, S, nh, dk)
    v = (inner @ p["wv"]).reshape(B, S, nh, dk)
    gates = cx @ p["w_if"] + p["b_if"]
    ig, fg = gates[..., :nh], gates[..., nh:]
    mstate = ((state["C"].float(), state["n"].float(), state["m"].float())
              if state is not None else None)
    h, (C, n, m) = _chunked_mlstm(q, k, v, ig, fg, xc.chunk, mstate)
    h = h.reshape(B, S, di).to(x.dtype)
    h = rms_norm(h, p["norm_w"], cfg.norm_eps) * F.silu(z)
    new_state = None if state is None else {"C": C, "n": n, "m": m, "conv": new_conv}
    return h @ p["w_down"], new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_template(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dff = int(d * 4 / 3)
    return {
        "w_x": leaf((d, 4 * d), (None, "model")),           # i,f,z,o input proj
        "r_h": leaf((nh, hd, 4 * hd), (None, None, "model"), scale=0.05),  # block-diag recurrent
        "b": leaf((4 * d,), ("model",), init="zeros"),
        "norm_w": leaf((d,), (None,), init="ones"),
        "w_up1": leaf((d, dff), (None, "model")),
        "w_up2": leaf((d, dff), (None, "model")),
        "w_down": leaf((dff, d), ("model", None)),
    }


def slstm_state_template(cfg: ArchConfig, batch: int) -> Dict:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    sp = (DP, "model", None)
    return {"c": leaf((batch, nh, hd), sp, init="zeros"),
            "n": leaf((batch, nh, hd), sp, init="zeros"),
            "h": leaf((batch, nh, hd), sp, init="zeros"),
            "m": leaf((batch, nh, hd), sp, init="zeros")}


def _slstm_cell(p, nh: int, hd: int, carry, xw):
    """One step.  carry: (c, n, h, m) each (B, nh, hd); xw: (B, 4d), the
    step's input projection."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hde->bhe", h, p["r_h"].float())  # (B,nh,4hd)
    g = xw.reshape(xw.shape[0], nh, 4 * hd).float() + rec
    i_t, f_t, z_t, o_t = g.chunk(4, dim=-1)
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d), one cell step per token.  With ``state``
    (c, n, h, m): returns the new state too."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    xw = x @ p["w_x"] + p["b"]
    if state is None:
        z = torch.zeros((B, nh, hd), dtype=torch.float32, device=x.device)
        carry = (z, z, z, z)
    else:
        carry = tuple(state[k].float() for k in ("c", "n", "h", "m"))
    hs = []
    for t in range(S):
        carry = _slstm_cell(p, nh, hd, carry, xw[:, t])
        hs.append(carry[2])
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    h = rms_norm(h, p["norm_w"], cfg.norm_eps)
    # post-up-projection GeGLU (the paper's sLSTM block, factor 4/3); the
    # reference's jax.nn.gelu is the tanh approximation
    y = (F.gelu((h @ p["w_up1"]).float(), approximate="tanh")
         * (h @ p["w_up2"]).float()).to(x.dtype)
    new_state = None if state is None else dict(zip(("c", "n", "h", "m"), carry))
    return y @ p["w_down"], new_state
