"""Plain PyTorch versions of the tile kernels (``repro``'s ``ref.py``).

Same functions as the CUDA kernels, written as whole-batch tensor ops: the
CPU path of :mod:`.ops` and the yardstick ``chip_smoke.py`` and the tests
hold each kernel against.  The edge-list versions select the real edge
slots (``e < row_ptr[t, -1]`` or ``e < n_edge[t]``) before touching any
value, so padded slots may hold NaN, and they never build the TPU's dense
(T, D, E) score block or row selector.  ``tile_spmm_csr_plan_ref`` and
``segment_softmax_plan_ref`` walk an :class:`~.plan.EdgePlan` as the CUDA
kernels walk it.  The edge-list and plan versions take the source operand
in either of the kernels' forms: the replica (T, S, F) with tile-local
``col``, or the flat (V, F) store with global ``col``.
``segment_softmax_ref`` keeps ``repro``'s dense COO operands: the
counterpart of its function, off the runner's path.
"""
from __future__ import annotations

import torch

_NEG = -1e30
_LIVE = -1e29      # a COO score above this is a real edge (the reference's rule)


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


def _coo_edges(edge_dst, n_edge, part_id, dmax: int):
    """(tile, slot, flat destination row) of every real COO edge slot
    ``e < n_edge[t]``; the flat row is ``part_id[t] * dmax + edge_dst[t, e]``."""
    E = edge_dst.shape[1]
    e = torch.arange(E, device=edge_dst.device)
    t, slot = torch.nonzero(e[None, :] < n_edge.long()[:, None], as_tuple=True)
    return t, slot, part_id.long()[t] * dmax + edge_dst.long()[t, slot]


def _source_rows(xsrc, T: int):
    """The kernels' view of a source operand: (rows, tile stride S), the
    replica (T, S, F) as its (T S, F) rows, or the flat (V, F) store as it
    is, stride 0.  Edge e of tile t reads row ``t S + col[t, e]``."""
    if xsrc.dim() == 2:
        return xsrc.float(), 0
    S, F = xsrc.shape[-2:]
    return xsrc.reshape(T * S, F).float(), S


def _edge_rows(t, slot, col, xsrc):
    """The source row of every listed edge (tile ``t``, slot ``slot``):
    (n_edge, F)."""
    rows, S = _source_rows(xsrc, col.shape[0])
    return rows[t * S + col.long()[t, slot]]


def tile_spmm_csr_ref(row_ptr, col, w, xsrc, part_id, n_parts: int) -> torch.Tensor:
    """CSR version: row_ptr (T, D+1); col/w (T, E); xsrc (T, S, F) or
    (V, F)."""
    D = row_ptr.shape[1] - 1
    F = xsrc.shape[-1]
    t, slot, dest = _csr_edges(row_ptr, part_id, col.shape[1])
    msg = w.float()[t, slot, None] * _edge_rows(t, slot, col, xsrc)
    out = torch.zeros((n_parts * D, F), dtype=torch.float32, device=xsrc.device)
    return out.index_add_(0, dest, msg).view(n_parts, D, F)


def tile_spmm_csr_plan_ref(plan, col, w, xsrc, n_parts: int) -> torch.Tensor:
    """The CSR SpMM as the kernel walks it: every edge of ``plan``
    (:class:`~.plan.CsrPlan`) adds into its chunk's target row, rows with
    no edge stay 0, then each split row sums its partial rows.  col/w
    (T, E); xsrc (T, S, F) or (V, F)."""
    T, E = col.shape
    rows, S = _source_rows(xsrc, T)
    F = rows.shape[1]
    slot = plan.slot.long()
    src = (slot // E) * S + col.reshape(-1).long()[slot]
    msg = w.reshape(-1).float()[slot, None] * rows[src]
    buf = torch.zeros((plan.n_rows + plan.n_partial, F), dtype=torch.float32,
                      device=xsrc.device)
    buf.index_add_(0, plan.edge_tgt.long() & 0x7FFFFFFF, msg)
    ptr = plan.split_ptr.long()
    owner = torch.repeat_interleave(plan.split_row.long(), ptr[1:] - ptr[:-1])
    out = buf[:plan.n_rows]
    out.index_add_(0, owner, buf[plan.n_rows:])
    return out.view(n_parts, -1, F)


def _edge_softmax(dest, s, x, n_rows: int, coo: bool):
    """Per row r: softmax over its edges' scores ``s`` (where ``dest == r``)
    weighting their rows of ``x`` (n_edge, F).  ``coo``: an edge counts only
    where s > -1e29 (``_softmax_kernel``'s rule); else every edge counts.
    Rows with no edge give 0.  Returns (m, l, acc): the row max, the sum of
    exp(s - m) and the weighted sum of x, unnormalized."""
    dev = s.device
    live = s > _LIVE if coo else torch.ones_like(s, dtype=torch.bool)
    s = torch.where(live, s.float(), _NEG)
    m = torch.full((n_rows,), _NEG, dtype=torch.float32, device=dev)
    m.scatter_reduce_(0, dest, s, "amax", include_self=True)
    p = torch.where(live, torch.exp(s - m[dest]), 0.0)
    den = torch.zeros((n_rows,), dtype=torch.float32, device=dev)
    den.index_add_(0, dest, p)
    acc = torch.zeros((n_rows, x.shape[-1]), dtype=torch.float32, device=dev)
    acc.index_add_(0, dest, p[:, None] * x.float())
    return m, den, acc


def segment_softmax_csr_ref(row_ptr, col, scores, xsrc, part_id,
                            n_parts: int) -> torch.Tensor:
    """CSR softmax: row_ptr (T, D+1); col/scores (T, E) per edge; xsrc
    (T, S, F) or (V, F).  out[p, d] = sum over the edges of row d in p's
    tiles of softmax(score) * xsrc[t, col[t, e]] (xsrc[col[t, e]]); every
    real slot counts."""
    D = row_ptr.shape[1] - 1
    t, slot, dest = _csr_edges(row_ptr, part_id, scores.shape[1])
    _, den, acc = _edge_softmax(dest, scores[t, slot], _edge_rows(t, slot, col, xsrc),
                                n_parts * D, coo=False)
    return (acc / den.clamp_min(1e-30)[:, None]).view(n_parts, D, -1)


def segment_softmax_coo_ref(edge_dst, n_edge, col, scores, xsrc, part_id,
                            n_parts: int, dmax: int) -> torch.Tensor:
    """COO softmax on per-edge operands: edge_dst/col/scores (T, E), n_edge
    (T,), xsrc (T, S, F) or (V, F); an edge counts where its score is above
    -1e29.
    The same function as :func:`segment_softmax_ref` on the densified
    scores and ``vals = xsrc[t, col]``."""
    t, slot, dest = _coo_edges(edge_dst, n_edge, part_id, dmax)
    _, den, acc = _edge_softmax(dest, scores[t, slot], _edge_rows(t, slot, col, xsrc),
                                n_parts * dmax, coo=True)
    return (acc / den.clamp_min(1e-30)[:, None]).view(n_parts, dmax, -1)


def segment_softmax_plan_ref(plan, col, scores, xsrc, n_parts: int, *,
                             coo: bool) -> torch.Tensor:
    """Either softmax as the kernel walks ``plan`` (:class:`~.plan.EdgePlan`):
    every chunk folds its edges into a partial (m, l, acc) on its target
    row; an unsplit row is acc / max(l, 1e-30), a split row merges its
    chunks' partials (m = max m_k, l = sum l_k e^(m_k - m), acc likewise)
    first.  col/scores (T, E); xsrc (T, S, F) or (V, F); ``coo`` picks the
    liveness rule."""
    T, E = col.shape
    rows, S = _source_rows(xsrc, T)
    F = rows.shape[1]
    slot = plan.slot.long()
    x = rows[(slot // E) * S + col.reshape(-1).long()[slot]]
    m, den, acc = _edge_softmax(plan.edge_tgt.long() & 0x7FFFFFFF,
                                scores.reshape(-1)[slot], x,
                                plan.n_rows + plan.n_partial, coo=coo)
    n = plan.n_rows
    ptr = plan.split_ptr.long()
    owner = torch.repeat_interleave(plan.split_row.long(), ptr[1:] - ptr[:-1])
    m_row = m[:n].clone().scatter_reduce_(0, owner, m[n:], "amax")
    scale = torch.exp(m[n:] - m_row[owner])
    den_row = den[:n].index_add(0, owner, den[n:] * scale)
    acc_row = acc[:n].index_add(0, owner, acc[n:] * scale[:, None])
    return (acc_row / den_row.clamp_min(1e-30)[:, None]).view(n_parts, -1, F)


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
