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
