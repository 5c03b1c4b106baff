"""Mamba2 (SSD) block — chunked selective state-space layer (Zamba2 backbone).

Ports ``repro.models.mamba2``, on one device or laid out over a
:class:`~repro_torch.core.exchange.ShardMesh` by the template's specs (one
body for both, :func:`mamba2_block`).  The reference's ``lax.scan``
over sequence chunks is a Python loop here: each chunk's intra-chunk
lower-triangular product, the carried state's contribution and the state
update, in that order and in float32.  No Pallas kernel computes any of it
in the reference, so torch ops are the whole port.

Shapes follow the Mamba2 paper: d_inner = expand·d, heads = d_inner/head_dim,
scalar decay A per head, grouped B/C (n_groups).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import (DP, leaf, model_sharded, off_ranks, on_ranks, own_range, rms_norm_split,
                     row_parallel, take_leaf, whole, whole_leaf)


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
        # exp overflows above the diagonal: select before exp, never after
        # (exp's backward would multiply the masked zero by inf: NaN)
        w = torch.exp(torch.where(mask, decay, -torch.inf)) * scores
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


def conv_all_channels(sp, xs: List[torch.Tensor], states=None, spec=None):
    """The depthwise causal conv (:func:`_causal_conv`) over every channel,
    on every local rank: each ``xs[j]`` holds all C channels (B, S, C), and
    ``conv_w`` / ``conv_b`` of ``sp`` are all-gathered over model where their
    spec splits the channels (the channels of a fused projection cut across
    its segments, so a rank's block is not the channels it reads).  With
    ``states`` (each rank's block of the conv cache, laid out by ``spec``:
    (B, W - 1, C) split over model on its channels or whole), the whole
    previous inputs are all-gathered likewise, and each rank's block of the
    new state is cut from the whole one.  Returns the outputs and the new
    state blocks (None without ``states``)."""
    mesh = sp.mesh
    ws, bs = whole_leaf(sp, "conv_w"), whole_leaf(sp, "conv_b")
    if states is None:
        return [_causal_conv(x, w, b)[0] for x, w, b in zip(xs, ws, bs)], None
    sharded = model_sharded(spec[2])
    full = whole(mesh, states, 2, sharded)
    outs, news = [], []
    for x, w, b, st, blk, r in zip(xs, ws, bs, full, states, mesh.local_ranks):
        o, new = _causal_conv(x, w, b, st)
        c = blk.shape[2]
        outs.append(o)
        news.append(new.narrow(2, mesh.axis_index(r, "model") * c, c) if sharded else new)
    return outs, news


def mamba2_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *, mesh=None,
                 state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d).  With ``state``: single-step decode (S
    should be 1), returning the new recurrent and conv state.

    One body for a mesh and for none.  Without ``mesh`` it is a lone rank
    (``common.on_ranks``): ``p`` and ``state`` whole dicts, taken as they
    are, and ``x`` a tensor; nothing is sharded, so no collective runs and
    the arithmetic is the single-device block's.  With ``mesh``, ``p`` and
    ``state`` are :class:`~repro_torch.models.common.ShardedTree` s laid out
    by :func:`mamba2_template` / :func:`mamba2_state_template` and ``x`` one
    (B_loc, S, d) block a local rank, and so are the outputs (the new state
    one dict a rank, in the state's layout).  A rank computes its block of
    the heads (all of them where they do not divide the model axis):

    * ``w_in``'s column blocks cut across the [z | x | B | C | dt] segments,
      so each rank projects onto its columns and the projection is
      all-gathered over model (one collective); every rank then reads its
      heads' z, x and dt and all of B and C (the groups its heads use);
    * the conv runs over every channel on every rank
      (:func:`conv_all_channels`: ``conv_w`` / ``conv_b`` and a decode's conv
      cache gathered, each rank's cache block cut back from the new state);
    * ``dt_bias`` / ``a_log`` / ``d_skip``, ``norm_w`` and the ``ssm`` state
      are split by heads as the rank's heads are: its own blocks;
    * the gated RMS norm spans the ranks' blocks of d_inner: a psum of the
      sums of squares (``common.rms_norm_split``);
    * ``w_out`` is row parallel: each rank's rows, then a psum over model.
    """
    s, di, nh, conv_ch = _dims(cfg)
    sp, xs, st = on_ranks(p, x, state, mesh)
    ranks = sp.mesh
    hd, G, N = s.head_dim, s.n_groups, s.d_state
    GN = G * N
    n_in = 2 * di + 2 * GN + nh
    w_in, in_spec = sp.gathered("w_in")
    zxs = whole(ranks, [t @ w for t, w in zip(xs, w_in)], -1, model_sharded(in_spec[-1]))

    def heads_of(m, unit=1, at=0):
        lo, hi = own_range(ranks, nh, m, unit)
        return [(at + lo, at + hi)]

    per_head = [take_leaf(sp, k, 0, heads_of) for k in ("dt_bias", "a_log", "d_skip")]
    norm_w = take_leaf(sp, "norm_w", 0, lambda m: heads_of(m, hd))
    xbcs = [t[..., di:di + conv_ch] for t in zxs]
    convs, new_convs = conv_all_channels(
        sp, xbcs, None if st is None else st.local("conv"),
        None if st is None else st.specs["conv"])
    rep = nh // G
    ys, new_ssm = [], []
    for j, (zx, cx, r) in enumerate(zip(zxs, convs, ranks.local_ranks)):
        m = ranks.axis_index(r, "model")
        a, b = own_range(ranks, nh, m)
        B, S, _ = zx.shape
        z = zx[..., a * hd:b * hd]
        dt = zx[..., di + conv_ch + a:di + conv_ch + b]
        dt_bias, a_log, d_skip = (t[j] for t in per_head)
        dt = F.softplus(dt.float() + dt_bias.float())
        A = -torch.exp(a_log.float())
        xh = cx[..., a * hd:b * hd].reshape(B, S, b - a, hd)
        g0, g1 = a // rep, -(-b // rep)    # the groups of the rank's heads
        if (b - a) % (g1 - g0):
            raise ValueError(f"{b - a} heads a rank straddle {g1 - g0} of {G} groups")
        Bm = cx[..., di:di + GN].reshape(B, S, G, N)[:, :, g0:g1]
        Cm = cx[..., di + GN:].reshape(B, S, G, N)[:, :, g0:g1]

        if st is None:
            y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
        else:
            # single-step recurrence: h = h*exp(dt*A) + dt*B x ; y = C·h
            h = st.blocks[j]["ssm"].float()                      # (B,nh,hd,N)
            rep_ = (b - a) // (g1 - g0)
            Bh = Bm[:, 0].repeat_interleave(rep_, dim=1).float()  # (B,nh,N)
            Ch = Cm[:, 0].repeat_interleave(rep_, dim=1).float()
            dt0 = dt[:, 0]                                       # (B,nh)
            xdt = xh[:, 0].float() * dt0[..., None]              # (B,nh,hd)
            h = h * torch.exp(dt0 * A)[:, :, None, None] + torch.einsum("bhd,bhn->bhdn",
                                                                        xdt, Bh)
            y = torch.einsum("bhdn,bhn->bhd", h, Ch)[:, None]
            new_ssm.append(h)
        y = y + xh.float() * d_skip.float()[None, None, :, None]
        y = y.reshape(B, S, (b - a) * hd).to(xs[j].dtype)
        ys.append(y * F.silu(z))
    ys = rms_norm_split(ranks, ys, norm_w, cfg.norm_eps, di)
    w_out, out_spec = sp.gathered("w_out")
    full = own_range(ranks, nh, 0) == (0, nh)
    outs = row_parallel(ranks, ys, w_out, out_spec, full=full)
    news = None
    if st is not None:
        news = [{"ssm": h, "conv": c} for h, c in zip(new_ssm, new_convs)]
    return off_ranks(mesh, outs, news)
