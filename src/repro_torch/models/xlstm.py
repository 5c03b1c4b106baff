"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, step recurrence).  [arXiv:2405.04517]

Ports ``repro.models.xlstm``, on one device or laid out over a
:class:`~repro_torch.core.exchange.ShardMesh` by the templates' specs (one
body a block for both).  The mLSTM keeps the
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
from .common import (DP, leaf, model_sharded, off_ranks, on_ranks, own_range, rms_norm_split,
                     row_parallel, take_leaf, whole, whole_leaf)
# the mLSTM's conv is the same arithmetic as the Mamba2 block's (the
# reference keeps two copies of it)
from .mamba2 import _causal_conv, conv_all_channels

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
        # exp overflows above the diagonal: select before exp, never after
        # (exp's backward would multiply the masked zero by inf: NaN)
        w = torch.exp(torch.where(mask, logw, -torch.inf))  # (B,L,L,nh)
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


def mlstm_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *, mesh=None,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d).  With ``state`` (C, n, m, conv): returns
    the new state too.

    One body for a mesh and for none, as ``mamba2.mamba2_block`` (``p``,
    ``x``, ``state`` and the outputs likewise).  A rank computes its block
    of the heads (all of them where they do not divide the model axis):

    * ``w_up``'s column blocks split [inner | z] off the middle (at model =
      2 one rank holds all of inner, the other all of z), so the up
      projection is all-gathered over model (one collective);
    * q / k and the gate logits contract over all of d_inner: the conv runs
      over every channel on every rank (``mamba2.conv_all_channels``), and
      each rank multiplies the whole conv output (and, for v, the whole
      inner) by its heads' columns of ``wq`` / ``wk`` / ``wv`` (its own
      blocks) and of ``w_if`` / ``b_if`` = [i | f] (gathered where a block
      is not the rank's heads: they are 2 x heads wide);
    * ``norm_w`` and the C / n / m state are the rank's heads' blocks; the
      RMS norm over d_inner is a psum of the sums of squares;
    * ``w_down`` is row parallel: a psum over model.
    """
    xc, di, nh, dk = _mdims(cfg)
    sp, xs, st = on_ranks(p, x, state, mesh)
    ranks = sp.mesh
    w_up, up_spec = sp.gathered("w_up")
    ups = whole(ranks, [t @ w for t, w in zip(xs, w_up)], -1, model_sharded(up_spec[-1]))
    inners = [u[..., :di] for u in ups]
    cxs, new_convs = conv_all_channels(
        sp, inners, None if st is None else st.local("conv"),
        None if st is None else st.specs["conv"])

    def cols(m):
        return [own_range(ranks, nh, m, dk)]

    def gate_cols(m):
        lo, hi = own_range(ranks, nh, m)
        return [(lo, hi), (nh + lo, nh + hi)]

    wq, wk, wv = (take_leaf(sp, k, 1, cols) for k in ("wq", "wk", "wv"))
    w_if, b_if = take_leaf(sp, "w_if", 1, gate_cols), take_leaf(sp, "b_if", 0, gate_cols)
    norm_w = take_leaf(sp, "norm_w", 0, cols)
    hs, zs, new_states = [], [], []
    for j, (up, inner, cx, r) in enumerate(zip(ups, inners, cxs, ranks.local_ranks)):
        a, b = own_range(ranks, nh, ranks.axis_index(r, "model"))
        B, S, _ = up.shape
        zs.append(up[..., di + a * dk:di + b * dk])
        q = (cx @ wq[j]).reshape(B, S, b - a, dk)
        k = (cx @ wk[j]).reshape(B, S, b - a, dk)
        v = (inner @ wv[j]).reshape(B, S, b - a, dk)
        gates = cx @ w_if[j] + b_if[j]
        ig, fg = gates[..., :b - a], gates[..., b - a:]
        blk = None if st is None else st.blocks[j]
        mstate = ((blk["C"].float(), blk["n"].float(), blk["m"].float())
                  if blk is not None else None)
        h, (C, n, m) = _chunked_mlstm(q, k, v, ig, fg, xc.chunk, mstate)
        hs.append(h.reshape(B, S, (b - a) * dk).to(xs[j].dtype))
        new_states.append({"C": C, "n": n, "m": m, "conv": None if st is None else new_convs[j]})
    hs = [h * F.silu(z) for h, z in zip(rms_norm_split(ranks, hs, norm_w, cfg.norm_eps, di), zs)]
    w_down, down_spec = sp.gathered("w_down")
    outs = row_parallel(ranks, hs, w_down, down_spec, full=own_range(ranks, nh, 0) == (0, nh))
    return off_ranks(mesh, outs, None if st is None else new_states)


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


def slstm_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *, mesh=None,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d), one cell step per token.  With ``state``
    (c, n, h, m): returns the new state too.

    One body for a mesh and for none, as ``mamba2.mamba2_block``.  The
    input projection's columns are head-major ([i f z o] of head 0, then
    head 1, ...: the cell reshapes them (B, heads, 4 hd)), so a rank's
    column blocks of ``w_x`` / ``b`` are its heads' four gates where the
    heads divide the model axis.  ``r_h``'s spec splits its last dimension
    (the 4 x hd gate columns of every head: one gate of each head a rank at
    model = 4), while the recurrence needs all four gates of a head at every
    token.  Collectives inside the token loop would be one a token, so
    ``r_h`` is all-gathered over model once a block and each rank runs the
    loop on its own heads with their whole recurrent block (one head a rank
    at model = 4; every head on every rank where they do not divide).  The
    RMS norm over d spans the ranks' heads (a psum of the sums of squares);
    the normed output is all-gathered over model for the GeGLU, whose up
    projections are column parallel and ``w_down`` row parallel (a psum).
    """
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    sp, xs, st = on_ranks(p, x, state, mesh)
    ranks = sp.mesh

    def heads(m, unit=1):
        return [own_range(ranks, nh, m, unit)]

    w_x = take_leaf(sp, "w_x", 1, lambda m: heads(m, 4 * hd))
    bias = take_leaf(sp, "b", 0, lambda m: heads(m, 4 * hd))
    r_h = whole_leaf(sp, "r_h")
    norm_w = take_leaf(sp, "norm_w", 0, lambda m: heads(m, hd))
    hs, new_states = [], []
    for j, (t, r) in enumerate(zip(xs, ranks.local_ranks)):
        a, b = own_range(ranks, nh, ranks.axis_index(r, "model"))
        B, S, _ = t.shape
        xw = t @ w_x[j] + bias[j]
        if st is None:
            z = torch.zeros((B, b - a, hd), dtype=torch.float32, device=t.device)
            carry = (z, z, z, z)
        else:
            carry = tuple(st.blocks[j][k].float() for k in ("c", "n", "h", "m"))
        cell = {"r_h": r_h[j] if (a, b) == (0, nh) else r_h[j][a:b]}
        steps = []
        for i in range(S):
            carry = _slstm_cell(cell, b - a, hd, carry, xw[:, i])
            steps.append(carry[2])
        hs.append(torch.stack(steps, dim=1).reshape(B, S, (b - a) * hd).to(t.dtype))
        new_states.append(dict(zip(("c", "n", "h", "m"), carry)))
    hs = rms_norm_split(ranks, hs, norm_w, cfg.norm_eps, d)
    hs = whole(ranks, hs, -1, own_range(ranks, nh, 0) != (0, nh))
    (w1, s1), (w2, _), (wd, sd) = (sp.gathered(k) for k in ("w_up1", "w_up2", "w_down"))
    # post-up-projection GeGLU (the paper's sLSTM block, factor 4/3); the
    # reference's jax.nn.gelu is the tanh approximation
    ys = [(F.gelu((h @ u1).float(), approximate="tanh") * (h @ u2).float()).to(h.dtype)
          for h, u1, u2 in zip(hs, w1, w2)]
    outs = row_parallel(ranks, ys, wd, sd, full=not model_sharded(s1[-1]))
    return off_ranks(mesh, outs, None if st is None else new_states)
