"""The CSR plan: a tile batch's edge slots regrouped by destination row.

The CSR tile SpMM kernel does not walk the per-tile row pointers (for row d
that is one strided read of ``row_ptr[t, d:d+2]`` per tile of the
partition).  It walks a plan built once per tile set, on the tensors'
device, from ``row_ptr`` and ``part_id``:

* ``row_start`` (P·D + 1,) int32: the edges of flat row ``r = p·D + d`` are
  plan edges ``[row_start[r], row_start[r+1])``;
* ``slot`` (n_edge,) int32: ``t·E + e`` of every real edge slot, grouped by
  row, in tile order within a row (a stable sort);
* chunks: every row is cut into runs of at most ``chunk_size`` edges.
  ``edge_tgt`` (n_edge,) int32 gives each edge its chunk's target row, with
  bit 31 set on a chunk's last edge (where the kernel stores the row): the
  output row of an unsplit row, and row ``P·D + k`` for the k-th chunk of a
  split row (its partial sum goes to a scratch block below the output);
* ``group_ptr`` (n_group + 1,) int32, the schedule: one warp takes the
  edges ``[group_ptr[g], group_ptr[g+1])``, whole chunks that start within
  one 32-edge window of the edge list, so a warp folds ~32 edges of short
  rows, or one chunk of a hub row: the work is edge-balanced and a hub row
  spreads over as many warps as it has chunks;
* ``zero_row`` (n_zero,) int32: rows with no edge (the kernel writes 0);
* ``split_row`` (n_split,) and ``split_ptr`` (n_split + 1,) int32: split
  row i sums partials ``[split_ptr[i], split_ptr[i+1])`` in a second,
  deterministic pass.

Padded edge slots (``e >= row_ptr[t, D]``) appear nowhere in it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .ref import _csr_edges

#: most edges one warp folds into one output row before the row is split
CHUNK_SIZE = 128
#: edges a warp's group starts within (its chunks may run past it)
GROUP_EDGES = 32
LAST = -2 ** 31        # bit 31 of edge_tgt: the last edge of its chunk


@dataclass(frozen=True)
class CsrPlan:
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


def csr_plan(row_ptr: torch.Tensor, part_id: torch.Tensor, n_parts: int,
             n_edge_cols: int, chunk_size: int = CHUNK_SIZE) -> CsrPlan:
    """Build the plan of a CSR tile batch on ``row_ptr``'s device.

    row_ptr (T, D+1) and part_id (T,) int32 tensors; ``n_edge_cols`` is E,
    the edge-slot width of ``col`` and ``w``.  Syncs the host (its sizes
    depend on the data): build it once per tile set, not per call."""
    dev = row_ptr.device
    D = row_ptr.shape[1] - 1
    n_rows = n_parts * D
    t, e, dest = _csr_edges(row_ptr, part_id, n_edge_cols)
    dest, order = torch.sort(dest, stable=True)
    slot = (t * n_edge_cols + e)[order].to(torch.int32)
    counts = torch.bincount(dest, minlength=n_rows)
    row_start = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    row_start[1:] = counts.cumsum(0)

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

    split_ptr = torch.zeros(int(split.sum()) + 1, dtype=torch.int64, device=dev)
    split_ptr[1:] = per_row[split].cumsum(0)
    return CsrPlan(n_rows=n_rows, n_partial=int(split_ptr[-1]),
                   chunk_size=chunk_size,
                   row_start=row_start.to(torch.int32), slot=slot,
                   edge_tgt=edge_tgt, group_ptr=group_ptr.to(torch.int32),
                   zero_row=torch.nonzero(counts == 0).flatten().to(torch.int32),
                   split_row=torch.nonzero(split).flatten().to(torch.int32),
                   split_ptr=split_ptr.to(torch.int32))
