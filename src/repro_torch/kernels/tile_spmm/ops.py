"""TileSet -> kernel operands, and the device dispatch of the tile kernels.

``densify_tiles`` turns a ZIPPER :class:`TileSet` (or each bucket of a
:class:`BucketedTileSet`) into the block-dense adjacency the COO kernel
consumes; ``densify_edge_weights`` does the same on the device for per-edge
weights computed at run time.  ``densify_edge_scores`` builds ``repro``'s
dense (T, D, E) score block, the TPU kernel's operand: no kernel of the
port takes it.  ``spmm`` / ``gat_aggregate`` / ``spmm_csr`` /
``gat_aggregate_csr`` are the entry points the runner calls: CPU tensors
take the plain PyTorch version (``ref.py``), CUDA tensors launch the
hand-written kernel (``kernel.py``), which raises rather than falling back.
The runner passes what it built at bind time: ``part_ptr`` (partition
runs) for the COO SpMM and the edge ``plan`` for the others.  The
plan-walking entry points take the source operand ``xsrc`` as the tiles'
replica (T, S, F) with tile-local ``col``, or as the flat (V, F) store with
global ``col`` (``src_ids[t, edge_src[t, e]]``); the COO SpMM multiplies
dense blocks, so it takes the replica alone.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ...core.tiling import BucketedTileSet, TileSet
from . import kernel as K
from . import ref as R
from .plan import EdgePlan

_NEG = -1e30  # matches the TPU segment-softmax kernel's "no edge" sentinel


def densify_tiles(tiles: Union[TileSet, BucketedTileSet],
                  edge_weight: Optional[np.ndarray] = None):
    """Build dense per-tile adjacency blocks A (T, Dmax, Smax).

    A[t, d, s] = sum of weights of edges (s -> d) in tile t (1.0 default).
    Also returns the FIRST/LAST flags.  numpy, one-time preprocessing —
    the analogue of the paper's offline tiling pass.

    For a :class:`BucketedTileSet` the result is one (adj, flags) pair per
    bucket — Smax differs per bucket (that is the point of bucketing) while
    Dmax stays the shared partition maximum, so per-bucket kernel outputs
    can be summed into one (P, Dmax, F) accumulator.
    """
    if isinstance(tiles, BucketedTileSet):
        return [densify_tiles(b, edge_weight) for b in tiles.buckets]
    T, S = tiles.edge_src.shape
    D = int(tiles.part_size.max())
    Smax = tiles.s_max
    adj = np.zeros((T, D, Smax), np.float32)
    for t in range(T):
        ne = int(tiles.n_edge[t])
        w = np.ones(ne, np.float32) if edge_weight is None else \
            edge_weight[tiles.edge_gid[t, :ne]]
        np.add.at(adj[t], (tiles.edge_dst[t, :ne], tiles.edge_src[t, :ne]), w)
    return adj, K.tile_flags(tiles.part_id)


def gather_sources(tiles: Union[TileSet, BucketedTileSet], x: torch.Tensor):
    """(T, Smax, F) compacted source features (sparse tiling's gather) on
    ``x``'s device; one tensor per bucket for a :class:`BucketedTileSet`."""
    if isinstance(tiles, BucketedTileSet):
        return [gather_sources(b, x) for b in tiles.buckets]
    return x[torch.as_tensor(tiles.src_ids, device=x.device).long()]


def _edge_mask(n_edge: torch.Tensor, n_cols: int) -> torch.Tensor:
    return (torch.arange(n_cols, device=n_edge.device)[None, :]
            < n_edge[:, None])


def densify_edge_weights(weights, edge_dst, edge_src, n_edge, *,
                         dmax: int, smax: int) -> torch.Tensor:
    """Runtime analogue of :func:`densify_tiles` for *computed* edge weights.

    weights: (T, Emax) per-edge scalars; edge_dst/edge_src: (T, Emax)
    tile-local indices; n_edge: (T,) true counts.  Returns (T, dmax, smax)
    dense adjacency blocks with parallel edges summed — the A operand of the
    weighted-SpMM kernel block.
    """
    T, E = weights.shape
    w = torch.where(_edge_mask(n_edge, E), weights, 0.0).float()
    adj = torch.zeros((T, dmax, smax), dtype=torch.float32,
                      device=weights.device)
    t = torch.arange(T, device=weights.device)[:, None].expand(T, E)
    return adj.index_put_((t, edge_dst.long(), edge_src.long()), w,
                          accumulate=True)


def densify_edge_scores(scores, edge_dst, n_edge, *, dmax: int) -> torch.Tensor:
    """Per-edge-COLUMN score densification for ``repro``'s segment-softmax
    kernel (the port's kernels take the per-edge scores themselves).

    scores: (T, Emax) per-edge attention logits.  Returns (T, dmax, Emax)
    blocks where column ``j`` holds edge ``j``'s score at its destination row
    and the ``_NEG`` sentinel everywhere else.  Giving every edge its own
    column keeps parallel edges in separate softmax slots, so multigraphs
    stay exact.
    """
    T, E = scores.shape
    s = torch.where(_edge_mask(n_edge, E), scores, _NEG).float()
    out = torch.full((T, dmax, E), _NEG, dtype=torch.float32,
                     device=scores.device)
    t = torch.arange(T, device=scores.device)[:, None].expand(T, E)
    e = torch.arange(E, device=scores.device)[None, :].expand(T, E)
    return out.index_put_((t, edge_dst.long(), e), s)


def spmm(adj, xsrc, part_id, flags, *, n_parts: int,
         part_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    if adj.device.type == "cpu":
        return R.tile_spmm_ref(adj, xsrc, part_id, n_parts)
    return K.tile_spmm_cuda(adj, xsrc, part_id, flags, n_parts=n_parts,
                            part_ptr=part_ptr)


def gat_aggregate(edge_dst, n_edge, col, scores, xsrc, part_id, flags, *,
                  n_parts: int, dmax: int,
                  plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """COO online segment softmax on per-edge operands: edge_dst/col/scores
    (T, E), n_edge (T,), xsrc (T, S, F) or (V, F), as ``col`` is tile-local
    or global.  ``plan`` (:func:`~.plan.coo_plan`
    of these tiles): the CUDA kernel walks it; on the CPU the plain version
    walks it the same way."""
    if scores.device.type == "cpu":
        if plan is not None:
            return R.segment_softmax_plan_ref(plan, col, scores, xsrc, n_parts,
                                              coo=True)
        return R.segment_softmax_coo_ref(edge_dst, n_edge, col, scores, xsrc,
                                         part_id, n_parts, dmax)
    return K.segment_softmax_cuda(edge_dst, n_edge, col, scores, xsrc, part_id,
                                  flags, n_parts=n_parts, dmax=dmax, plan=plan)


# ---------------------------------------------------------------------------
# CSR-within-tile entry points: no densify pass — ``col`` IS the CSR-ordered
# ``edge_src`` and weights/scores stay per-edge vectors.
# ---------------------------------------------------------------------------

def spmm_csr(row_ptr, col, w, xsrc, part_id, flags, *, n_parts: int,
             plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """col/w (T, E); xsrc (T, S, F) or (V, F), as ``col`` is tile-local or
    global.  ``plan`` (:func:`~.plan.csr_plan` of these tiles): the CUDA
    kernel walks it; on the CPU the plain version walks it the same way."""
    if row_ptr.device.type == "cpu":
        if plan is not None:
            return R.tile_spmm_csr_plan_ref(plan, col, w, xsrc, n_parts)
        return R.tile_spmm_csr_ref(row_ptr, col, w, xsrc, part_id, n_parts)
    return K.tile_spmm_csr_cuda(row_ptr, col, w, xsrc, part_id, flags,
                                n_parts=n_parts, plan=plan)


def gat_aggregate_csr(row_ptr, col, scores, xsrc, part_id, flags, *,
                      n_parts: int,
                      plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """CSR online segment softmax: col/scores (T, E), xsrc (T, S, F) or
    (V, F); ``plan`` as for :func:`spmm_csr`."""
    if row_ptr.device.type == "cpu":
        if plan is not None:
            return R.segment_softmax_plan_ref(plan, col, scores, xsrc, n_parts,
                                              coo=False)
        return R.segment_softmax_csr_ref(row_ptr, col, scores, xsrc, part_id,
                                         n_parts)
    return K.segment_softmax_csr_cuda(row_ptr, col, scores, xsrc, part_id,
                                      flags, n_parts=n_parts, plan=plan)
