"""The edge plan: a tile batch's edge slots regrouped by destination row.

The plan-walking kernels (the CSR tile SpMM and both segment softmaxes) do
not walk the per-tile layout (for row d of a CSR tile set that is one
strided read of ``row_ptr[t, d:d+2]`` per tile of the partition; for COO
tiles a dense (T, D, E) score block).  They walk a plan built once per tile
set, on the tensors' device, from the (tile, slot, flat destination row)
triple of every real edge (:func:`edge_plan`).  :func:`csr_plan` takes the
triples from ``row_ptr``, :func:`coo_plan` from ``edge_dst`` and
``n_edge``; the plan itself knows no layout.  Parallel edges stay separate
plan edges, so multigraphs stay exact.

* ``row_start`` (P·D + 1,) int32: the edges of flat row ``r = p·D + d`` are
  plan edges ``[row_start[r], row_start[r+1])``;
* ``slot`` (n_edge,) int32: ``t·E + e`` of every real edge slot, grouped by
  row, in tile order within a row (a stable sort);
* chunks: every row is cut into runs of at most ``chunk_size`` edges.
  ``edge_tgt`` (n_edge,) int32 gives each edge its chunk's target row, with
  bit 31 set on a chunk's last edge (where the kernel stores the row): the
  output row of an unsplit row, and row ``P·D + k`` for the k-th chunk of a
  split row (its partial result goes to a scratch block below the output);
* ``group_ptr`` (n_group + 1,) int32, the schedule: one warp takes the
  edges ``[group_ptr[g], group_ptr[g+1])``, whole chunks that start within
  one 32-edge window of the edge list, so a warp folds ~32 edges of short
  rows, or one chunk of a hub row: the work is edge-balanced and a hub row
  spreads over as many warps as it has chunks;
* ``zero_row`` (n_zero,) int32: rows with no edge (the kernel writes 0);
* ``split_row`` (n_split,) and ``split_ptr`` (n_split + 1,) int32: split
  row i merges partials ``[split_ptr[i], split_ptr[i+1])`` in a second,
  deterministic pass.

Padded edge slots (``e >= row_ptr[t, D]`` or ``e >= n_edge[t]``) appear
nowhere in it.  Its sizes depend on the data, so a build syncs the host
(``nonzero`` lists the real slots, the chunk starts, the groups' first
chunks, the split rows and the zero rows; the partial count is read back;
``chip_smoke.py`` counts the syncs).  So it is made once per tile set, at
bind.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .ref import _coo_edges, _csr_edges

#: most edges one warp folds into one output row before the row is split
CHUNK_SIZE = 128
#: edges a warp's group starts within (its chunks may run past it)
GROUP_EDGES = 32
LAST = -2 ** 31        # bit 31 of edge_tgt: the last edge of its chunk


@dataclass(frozen=True)
class EdgePlan:
    n_rows: int             # P·D output rows
    n_partial: int          # partial-sum rows of the split rows' chunks
    chunk_size: int
    row_start: torch.Tensor
    slot: torch.Tensor
    edge_tgt: torch.Tensor
    group_ptr: torch.Tensor
    zero_row: torch.Tensor
    split_row: torch.Tensor
    split_ptr: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Bytes of the plan the kernel reads (``row_start`` it does not)."""
        return 4 * sum(t.numel() for t in (self.slot, self.edge_tgt,
                                            self.group_ptr, self.zero_row,
                                            self.split_row, self.split_ptr))


def edge_plan(t: torch.Tensor, e: torch.Tensor, dest: torch.Tensor,
              n_rows: int, n_edge_cols: int,
              chunk_size: int = CHUNK_SIZE) -> EdgePlan:
    """Build the plan of the real edges ``(t[i], e[i])`` (tile, slot) with
    flat destination rows ``dest[i] < n_rows``, given in (tile, slot) order,
    on ``dest``'s device.  ``n_edge_cols`` is E, the edge-slot width of the
    per-edge operands."""
    dev = dest.device
    dest, order = torch.sort(dest, stable=True)
    slot = (t * n_edge_cols + e)[order].to(torch.int32)
    row_start = torch.searchsorted(dest, torch.arange(n_rows + 1, device=dev))
    counts = row_start.diff()

    # chunk k of a row holds its edges [k C, k C + C); split rows' chunks
    # number their partial rows in row order
    pos = torch.arange(dest.numel(), device=dev) - row_start[dest]
    per_row = (counts + chunk_size - 1) // chunk_size
    split = per_row > 1
    n_split_chunks = torch.where(split, per_row, 0)
    first_partial = torch.cumsum(n_split_chunks, 0) - n_split_chunks
    k = pos // chunk_size
    tgt = torch.where(split[dest], n_rows + first_partial[dest] + k, dest)
    last = (pos == counts[dest] - 1) | (pos % chunk_size == chunk_size - 1)
    edge_tgt = torch.where(last, tgt + LAST, tgt).to(torch.int32)

    # a group: the chunks that start in one GROUP_EDGES window of the list
    start = torch.nonzero(pos % chunk_size == 0).flatten()
    window = start // GROUP_EDGES
    new = torch.ones_like(window, dtype=torch.bool)
    new[1:] = window[1:] != window[:-1]
    group_ptr = torch.cat([start[new], start.new_tensor([dest.numel()])])

    split_row = torch.nonzero(split).flatten()
    split_ptr = torch.zeros(split_row.numel() + 1, dtype=torch.int64, device=dev)
    split_ptr[1:] = per_row[split_row].cumsum(0)
    return EdgePlan(n_rows=n_rows, n_partial=int(split_ptr[-1]),
                    chunk_size=chunk_size,
                    row_start=row_start.to(torch.int32), slot=slot,
                    edge_tgt=edge_tgt, group_ptr=group_ptr.to(torch.int32),
                    zero_row=torch.nonzero(counts == 0).flatten().to(torch.int32),
                    split_row=split_row.to(torch.int32),
                    split_ptr=split_ptr.to(torch.int32))


def csr_plan(row_ptr: torch.Tensor, part_id: torch.Tensor, n_parts: int,
             n_edge_cols: int, chunk_size: int = CHUNK_SIZE) -> EdgePlan:
    """The plan of a CSR tile batch: row_ptr (T, D+1) and part_id (T,)
    int32 tensors; ``n_edge_cols`` is E, the edge-slot width of ``col``."""
    D = row_ptr.shape[1] - 1
    t, e, dest = _csr_edges(row_ptr, part_id, n_edge_cols)
    return edge_plan(t, e, dest, n_parts * D, n_edge_cols, chunk_size)


def coo_plan(edge_dst: torch.Tensor, n_edge: torch.Tensor,
             part_id: torch.Tensor, n_parts: int, dmax: int,
             chunk_size: int = CHUNK_SIZE) -> EdgePlan:
    """The plan of a COO tile batch: edge_dst (T, E) tile-local destination
    rows, n_edge (T,) real-slot counts, part_id (T,); rows are ``part_id[t]
    · dmax + edge_dst[t, e]`` over the real slots ``e < n_edge[t]``."""
    t, e, dest = _coo_edges(edge_dst, n_edge, part_id, dmax)
    return edge_plan(t, e, dest, n_parts * dmax, edge_dst.shape[1], chunk_size)
