"""Plain PyTorch version of the grouped FFN over expert capacity buckets.

``expert_ffn_einsum`` of ``repro.kernels.moe_dispatch.ops`` (ops.py:89-93),
a SwiGLU per expert, with every row at or past ``counts[e]`` set to zero —
what ``grouped_ffn_pallas`` returns for buckets made by ``dispatch``, whose
dead rows are zero.  Computed in float32, cast to the buckets' dtype.
:func:`grouped_ffn_magnitude` is the scale of its fp32 rounding, against
which ``chip_smoke.py`` holds the CUDA kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_ffn_ref(buckets, w_gate, w_up, w_down, counts) -> torch.Tensor:
    """buckets: (E, C, d); w_gate/w_up: (E, d, f); w_down: (E, f, d);
    counts: (E,) live rows per expert.  Returns (E, C, d)."""
    E, C, _ = buckets.shape
    x = buckets.float()
    h = torch.einsum("ecd,edf->ecf", x, w_gate.float())
    u = torch.einsum("ecd,edf->ecf", x, w_up.float())
    y = torch.einsum("ecf,efd->ecd", F.silu(h) * u, w_down.float())
    live = torch.arange(C, device=buckets.device)[None, :] < counts.to(buckets.device)[:, None]
    return torch.where(live[..., None], y, 0.0).to(buckets.dtype)


def grouped_ffn_magnitude(buckets, w_gate, w_up, w_down, counts) -> torch.Tensor:
    """(E, C, d) float32: what the fp32 rounding of the grouped FFN scales
    with, stage by stage.  The gate and up sums round in proportion to
    |x| @ |W|; errors dg, du there move a = silu(g) * u by at most
    1.1 |u| dg + |silu(g)| du (|silu'| <= 1.1); the down sum rounds in
    proportion to |a| @ |Wd|, and carries a's error through |Wd|.  Rows at
    or past ``counts[e]`` are zero, as in the output."""
    E, C, _ = buckets.shape
    x = buckets.float()
    wg, wu = w_gate.float(), w_up.float()
    g = torch.einsum("ecd,edf->ecf", x, wg)
    u = torch.einsum("ecd,edf->ecf", x, wu)
    sg = F.silu(g)
    xa = x.abs()
    a_mag = ((sg * u).abs()
             + 1.1 * u.abs() * torch.einsum("ecd,edf->ecf", xa, wg.abs())
             + sg.abs() * torch.einsum("ecd,edf->ecf", xa, wu.abs()))
    del g, u, sg, wg, wu
    mag = torch.einsum("ecf,efd->ecd", a_mag, w_down.float().abs())
    live = torch.arange(C, device=buckets.device)[None, :] < counts.to(buckets.device)[:, None]
    return torch.where(live[..., None], mag, 0.0)


def grouped_ffn_bwd_magnitude(buckets, w_gate, w_up, w_down, counts, dy):
    """float32 tensors shaped like (d buckets, d w_gate, d w_up, d w_down):
    what the float32 rounding of the grouped FFN's backward scales with,
    stage by stage, for the output gradient ``dy`` (rows at or past
    ``counts[e]`` carry none).  With g = x Wg, u = x Wu rounding in
    proportion to Mg = |x| |Wg|, Mu = |x| |Wu|, and a = silu(g) u to
    Ma (as in :func:`grouped_ffn_magnitude`): dWd = a^T dy sums to Ma^T |dy|;
    da = dy Wd^T to Mda = |dy| |Wd|^T; dg = da u silu'(g) to Mdg = Mda |u
    silu'(g)| + |da| (|silu'(g)| Mu + 0.5 |u| Mg) (|silu''| <= 0.5); du = da
    silu(g) to Mdu = Mda |silu(g)| + 1.1 |da| Mg; dx = dg Wg^T + du Wu^T to
    Mdg |Wg|^T + Mdu |Wu|^T; dWg = x^T dg to |x|^T Mdg, dWu to |x|^T Mdu."""
    E, C, _ = buckets.shape
    live = (torch.arange(C, device=buckets.device)[None, :]
            < counts.to(buckets.device)[:, None])[..., None]
    x, wg, wu, wd = (t.float() for t in (buckets, w_gate, w_up, w_down))
    gy = torch.where(live, dy.float(), 0.0)
    xa, wga, wua, wda = x.abs(), wg.abs(), wu.abs(), wd.abs()
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    mg, mu = torch.bmm(xa, wga), torch.bmm(xa, wua)
    sig = torch.sigmoid(g)
    sg = g * sig
    dsilu = sig * (1 + g * (1 - sig))
    ma = (sg * u).abs() + 1.1 * u.abs() * mg + sg.abs() * mu
    dwd = torch.bmm(ma.transpose(1, 2), gy.abs())
    da = torch.bmm(gy, wd.transpose(1, 2))
    mda = torch.bmm(gy.abs(), wda.transpose(1, 2))
    mdg = mda * (u * dsilu).abs() + da.abs() * (dsilu.abs() * mu + 0.5 * u.abs() * mg)
    mdu = mda * sg.abs() + 1.1 * da.abs() * mg
    dx = torch.bmm(mdg, wga.transpose(1, 2)) + torch.bmm(mdu, wua.transpose(1, 2))
    return (torch.where(live, dx, 0.0), torch.bmm(xa.transpose(1, 2), mdg),
            torch.bmm(xa.transpose(1, 2), mdu), dwd)
