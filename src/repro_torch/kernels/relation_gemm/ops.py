"""The relation-grouped edge GEMM: out[e] = x[e] @ W[type[e]].

R-GCN's per-edge, type-selected product (the IR's ``bmm_edge``) over a
batch of edges.  :func:`relation_plan` groups the edges by relation on the
device (a stable sort by type and the segment offsets: no host sync).
:func:`relation_gemm` is differentiable in x and W through the same plan:
its backward is the GEMM again (W transposed, the plan's rows swapped, the
products added into the x rows) and the weight gradient.  For CUDA tensors
each of the three is one launch of a hand-written kernel (``kernel.py``),
which raises rather than falling back; for CPU tensors they are the plain
PyTorch versions (:func:`relation_gemm_ref`, :func:`relation_wgrad_ref`).
Types must lie in [0, R): the plan leaves an edge of another type out of
every segment.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import kernel as K


@dataclasses.dataclass
class RelationPlan:
    """Edges grouped by relation.  The i-th edge of the grouped order reads
    x row ``src_rows[i]`` and writes out row ``dst_rows[i]``; relation r's
    edges are ``[seg[r], seg[r + 1])`` of that order and its row tiles of
    ``K.BLOCK_ROWS`` edges ``[tile_off[r], tile_off[r + 1])``.  int32,
    on the edges' device."""

    src_rows: torch.Tensor   # (E,)
    dst_rows: torch.Tensor   # (E,)
    seg: torch.Tensor        # (R + 1,)
    tile_off: torch.Tensor   # (R + 1,)

    @property
    def n_edges(self) -> int:
        return self.src_rows.shape[0]

    @property
    def n_relations(self) -> int:
        return self.seg.shape[0] - 1


def relation_plan(types: torch.Tensor, n_relations: int) -> RelationPlan:
    """Group edges of ``types`` (E,) by relation, in edge order within a
    relation; the x row and the out row of an edge are its own index."""
    keys = types.reshape(-1).to(torch.int32)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(n_relations + 1, dtype=torch.int32, device=keys.device)
    seg = torch.searchsorted(sorted_keys, bounds)
    tiles = (seg[1:] - seg[:-1] + K.BLOCK_ROWS - 1) // K.BLOCK_ROWS
    tile_off = torch.cat([tiles.new_zeros(1), torch.cumsum(tiles, 0)])
    order = order.to(torch.int32)
    return RelationPlan(src_rows=order, dst_rows=order,
                        seg=seg.to(torch.int32), tile_off=tile_off.to(torch.int32))


def read_rows(plan: RelationPlan, rows: torch.Tensor) -> RelationPlan:
    """The plan with edge e reading x row ``rows[e]`` (a table of V rows,
    say, in place of E gathered edge rows); out rows stay the edges'."""
    src = rows.reshape(-1)[plan.src_rows.long()].to(torch.int32)
    return dataclasses.replace(plan, src_rows=src)


def relation_gemm_ref(x: torch.Tensor, w: torch.Tensor, plan: RelationPlan,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: one matmul per relation over its segment's rows
    (the segment bounds are read on the host).  Given ``out``, adds each
    edge's product to its row of ``out``, as the kernel does."""
    add = out is not None
    if not add:
        out = x.new_zeros((plan.n_edges, w.shape[-1]))
    seg = plan.seg.tolist()
    src, dst = plan.src_rows.long(), plan.dst_rows.long()
    for r in range(plan.n_relations):
        if seg[r + 1] > seg[r]:
            rows, y = dst[seg[r]:seg[r + 1]], x[src[seg[r]:seg[r + 1]]] @ w[r]
            if add:
                out.index_add_(0, rows, y)
            else:
                out[rows] = y
    return out


def relation_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                       plan: RelationPlan) -> torch.Tensor:
    """The plain weight gradient: (R, K, N), relation r's slice
    ``x[src]^T dy[dst]`` over its segment."""
    dw = x.new_zeros((plan.n_relations, x.shape[-1], dy.shape[-1]))
    seg = plan.seg.tolist()
    src, dst = plan.src_rows.long(), plan.dst_rows.long()
    for r in range(plan.n_relations):
        if seg[r + 1] > seg[r]:
            dw[r] = x[src[seg[r]:seg[r + 1]]].T @ dy[dst[seg[r]:seg[r + 1]]]
    return dw


def _gemm(x, w, plan, out=None):
    if x.device.type == "cuda":
        return K.relation_gemm_cuda(x.contiguous(), w.contiguous(), plan, out)
    return relation_gemm_ref(x, w, plan, out)


def _wgrad(x, dy, plan):
    if x.device.type == "cuda":
        return K.relation_wgrad_cuda(x.contiguous(), dy.contiguous(), plan)
    return relation_wgrad_ref(x, dy, plan)


class _RelationGemm(torch.autograd.Function):
    """:func:`relation_gemm` with its backward through the same plan."""

    @staticmethod
    def forward(ctx, x, w, src_rows, dst_rows, seg, tile_off):
        ctx.save_for_backward(x, w, src_rows, dst_rows, seg, tile_off)
        return _gemm(x, w, RelationPlan(src_rows, dst_rows, seg, tile_off))

    @staticmethod
    def backward(ctx, dy):
        x, w, src_rows, dst_rows, seg, tile_off = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[src_rows[i]] += dy[dst_rows[i]] @ W_r^T
            back = RelationPlan(dst_rows, src_rows, seg, tile_off)
            dx = _gemm(dy, w.transpose(1, 2), back, out=x.new_zeros(x.shape))
        if ctx.needs_input_grad[1]:
            dw = _wgrad(x, dy, RelationPlan(src_rows, dst_rows, seg, tile_off))
        return dx, dw, None, None, None, None


def relation_gemm(x: torch.Tensor, w: torch.Tensor,
                  plan: RelationPlan) -> torch.Tensor:
    """x: (M, K), the rows ``plan.src_rows`` index (E edge rows, or a
    table the edges read, :func:`read_rows`); w: (R, K, N).  Returns
    (E, N): each edge's row times its relation's weight.  Differentiable
    in ``x`` and ``w``."""
    return _RelationGemm.apply(x, w, plan.src_rows, plan.dst_rows, plan.seg,
                               plan.tile_off)
