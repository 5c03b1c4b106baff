"""Plain PyTorch versions of the four tile kernels (``repro``'s ``ref.py``).

Same functions as the CUDA kernels, written as whole-batch tensor ops: the
CPU path of :mod:`.ops` and the yardstick ``chip_smoke.py`` and the tests
hold each kernel against.  The CSR versions select the real edge slots
(``e < row_ptr[t, -1]``) before touching any value, so padded slots may hold
NaN, and they never build the TPU's (T, D, E) row selector.
``tile_spmm_csr_plan_ref`` is the CSR SpMM walked through a
:class:`~.plan.CsrPlan`, as the CUDA kernel walks it.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def tile_spmm_ref(adj, xsrc, part_id, n_parts: int) -> torch.Tensor:
    """adj: (T, D, S); xsrc: (T, S, F); part_id: (T,) -> out (P, D, F)."""
    D, F = adj.shape[1], xsrc.shape[-1]
    out = torch.zeros((n_parts, D, F), dtype=torch.float32, device=adj.device)
    return out.index_add_(0, part_id.long(),
                          torch.bmm(adj.float(), xsrc.float()))


def _csr_edges(row_ptr, part_id, n_edge_cols: int):
    """(tile, slot, flat destination row) of every real CSR edge slot; the
    flat row is ``part_id[t] * D + d`` with ``rp[t, d] <= e < rp[t, d+1]``."""
    T = row_ptr.shape[0]
    D = row_ptr.shape[1] - 1
    rp = row_ptr.long()
    e = torch.arange(n_edge_cols, device=rp.device).expand(T, n_edge_cols)
    row = torch.searchsorted(rp[:, 1:].contiguous(), e.contiguous(), right=True)
    t, slot = torch.nonzero(e < rp[:, -1:], as_tuple=True)
    return t, slot, part_id.long()[t] * D + row[t, slot]


def tile_spmm_csr_ref(row_ptr, col, w, xsrc, part_id, n_parts: int) -> torch.Tensor:
    """CSR version: row_ptr (T, D+1); col/w (T, E); xsrc (T, S, F)."""
    D = row_ptr.shape[1] - 1
    F = xsrc.shape[-1]
    t, slot, dest = _csr_edges(row_ptr, part_id, col.shape[1])
    msg = w.float()[t, slot, None] * xsrc.float()[t, col.long()[t, slot]]
    out = torch.zeros((n_parts * D, F), dtype=torch.float32, device=xsrc.device)
    return out.index_add_(0, dest, msg).view(n_parts, D, F)


def tile_spmm_csr_plan_ref(plan, col, w, xsrc, n_parts: int) -> torch.Tensor:
    """The CSR SpMM as the kernel walks it: every edge of ``plan``
    (:class:`~.plan.CsrPlan`) adds into its chunk's target row, rows with
    no edge stay 0, then each split row sums its partial rows.  col/w
    (T, E); xsrc (T, S, F)."""
    T, E = col.shape
    S, F = xsrc.shape[-2:]
    slot = plan.slot.long()
    src = (slot // E) * S + col.reshape(-1).long()[slot]
    msg = w.reshape(-1).float()[slot, None] * xsrc.reshape(T * S, F).float()[src]
    buf = torch.zeros((plan.n_rows + plan.n_partial, F), dtype=torch.float32,
                      device=xsrc.device)
    buf.index_add_(0, plan.edge_tgt.long() & 0x7FFFFFFF, msg)
    ptr = plan.split_ptr.long()
    owner = torch.repeat_interleave(plan.split_row.long(), ptr[1:] - ptr[:-1])
    out = buf[:plan.n_rows]
    out.index_add_(0, owner, buf[plan.n_rows:])
    return out.view(n_parts, -1, F)


def segment_softmax_csr_ref(row_ptr, scores, vals, part_id,
                            n_parts: int) -> torch.Tensor:
    """CSR softmax: scores (T, E) per edge; vals (T, E, F) per edge."""
    D = row_ptr.shape[1] - 1
    F = vals.shape[-1]
    t, slot, dest = _csr_edges(row_ptr, part_id, scores.shape[1])
    s = scores.float()[t, slot]
    dev = scores.device
    m = torch.full((n_parts * D,), _NEG, dtype=torch.float32, device=dev)
    m.scatter_reduce_(0, dest, s, "amax", include_self=True)
    p = torch.exp(s - m[dest])
    den = torch.zeros((n_parts * D,), dtype=torch.float32, device=dev)
    den.index_add_(0, dest, p)
    acc = torch.zeros((n_parts * D, F), dtype=torch.float32, device=dev)
    acc.index_add_(0, dest, p[:, None] * vals.float()[t, slot])
    return (acc / den.clamp_min(1e-30)[:, None]).view(n_parts, D, F)


def segment_softmax_ref(scores, vals, part_id, n_parts: int) -> torch.Tensor:
    """Online-softmax aggregation, COO form.

    scores: (T, D, E) per-edge columns, -1e30 where there is no edge;
    vals: (T, E, F).  out[p, d] = sum_e softmax(scores over all tiles of p
    at row d) * vals.
    """
    T, D, E = scores.shape
    F = vals.shape[-1]
    dev = scores.device
    pid = part_id.long()
    s = scores.float()
    m = torch.full((n_parts, D), _NEG, dtype=torch.float32, device=dev)
    m.scatter_reduce_(0, pid[:, None].expand(T, D), s.amax(-1), "amax",
                      include_self=True)
    p = torch.exp(s - m[pid][..., None])
    p = torch.where(s > _NEG / 2, p, 0.0)
    den = torch.zeros((n_parts, D), dtype=torch.float32, device=dev)
    den.index_add_(0, pid, p.sum(-1))
    acc = torch.zeros((n_parts, D, F), dtype=torch.float32, device=dev)
    acc.index_add_(0, pid, torch.bmm(p, vals.float()))
    return acc / den.clamp_min(1e-30)[..., None]
