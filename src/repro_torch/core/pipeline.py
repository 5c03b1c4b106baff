"""Tiled execution of a ScheduledProgram in PyTorch (port of
``repro.core.pipeline``): one interpreter of the
:class:`~repro_torch.core.schedule.ScheduledProgram` (``_Interpreter``),
which derives no levels or roles of its own, with three entry points:
:class:`PipelinedRunner` on one device, :class:`ShardedRunner` over a mesh
of shards (one interpreter a shard), and
:func:`~repro_torch.core.executor.run_tiled`, one call of a
:class:`PipelinedRunner` over a tile set.  Per phase:

* the destination block runs vectorized over partitions,
* gather blocks tagged ``pallas_spmm`` / ``pallas_spmm_weighted`` launch the
  COO or CSR tile-SpMM kernel once per size bucket (partition outputs summed
  into a shared (P, Dmax, F) buffer),
* a gather block tagged ``pallas_segment_softmax`` launches the online
  segment-softmax kernel over the unbucketed tile batch (softmax state
  cannot be merged across buckets) — GAT's three softmax phases in ONE pass,
  on per-edge scores and the batch's source operand, walking the batch's
  edge plan (built at bind, for either layout),
* the plan-walking kernels (CSR SpMM, either segment softmax) read a
  stored source value from the flat (V, F) store through the batch's
  global column ids (``gcol``, made at bind), and a value computed per
  slot from its (T, S_max, F) replica; the COO SpMM always takes the
  replica.  An edge block reads a stored source value by each edge's
  global source row in the same way, so no replica of it is built,
* ``scan``-tagged gathers (sage, rgcn) fold every tile's edges into the
  shared accumulators with one batched ``index_add_`` /
  ``scatter_reduce_`` per bucket, over each bucket's real edges (listed
  at bind).  Their edge blocks read a stored source value by each
  edge's global source row, and R-GCN's ``bmm_edge`` is one launch of
  the relation-grouped edge GEMM (``kernels/relation_gemm``) on a plan
  made once a run, and so is its backward.

The reference engine ``vmap``s and ``scan``s per tile; here the tile
dimension is written out, so every source, edge and kernel operand is a
(T, ...) tensor.  Execution is eager: a runner is built once per structure
signature and :meth:`PipelinedRunner.bind` / :meth:`~PipelinedRunner.run_with`
rebind another same-signature tile set without rebuilding.

``tiles`` may be a :class:`~repro_torch.core.tiling.TileSet` or a
:class:`~repro_torch.core.tiling.BucketedTileSet`.

While the recorder (:mod:`repro_torch.spans`) is on, a
:class:`PipelinedRunner` records ``runner.bind`` (child ``runner.plan``
around the edge plans and the COO densify) and ``runner.run`` (the host's
enqueue of the interpreter), and counts the host arrays it uploads
(``runner.h2d_bytes`` / ``runner.h2d_tensors``) and, each run, the padded
source slots of its batches, what a per-slot source block computes over
(``runner.src_rows_padded``: T x S_max of each batch;
``runner.src_rows_real``: the tiles' ``n_src``), the rows its source
blocks' vertex ops ran over (``runner.src_rows_computed``), the graph's
vertices and edges (``runner.vertices``, ``runner.edges``), the rows of
the (T, S_max, F) source replicas it built for kernel operands and edge
blocks (``runner.src_rows_replicated``, 0 where none is built), and the
rows its edge GEMMs ran over (``runner.edge_gemm_rows``) and the rows
its drains moved from partition layout to the vertex store
(``runner.unpad_rows``: V an unpad).  Around the
relation grouping it records ``runner.rel_plan``; for a program with an
edge GEMM it counts the graph's relations that have an edge
(``runner.rel_groups``, from the graph's ``edge_type`` on the host).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import compiler as C
from . import schedule as S
from .. import spans
from ..convert import to_device
from ..device import resolve
from ..gnn.graphs import Graph
from ..kernels.relation_gemm import ops as rops
from ..kernels.tile_spmm import ops as tops
from ..kernels.tile_spmm.kernel import (check_partition_major, partition_ptr,
                                        tile_flags)
from ..kernels.tile_spmm.plan import coo_plan, csr_plan
from .exchange import ShardMesh, default_devices
from .executor import _NEG_INF, apply_compute
from .tiling import (BucketedTileSet, ShardPlan, TileSet, exchange_sets,
                     plan_shards)

Array = torch.Tensor


def _padded_partition_ids(tiles) -> Tuple[np.ndarray, int]:
    """(P, Dmax) global vertex ids per partition row; invalid slots -> V."""
    P = tiles.n_dst_parts
    dmax = int(tiles.part_size.max())
    V = tiles.n_vertices
    ids = np.full((P, dmax), V, dtype=np.int32)
    for p in range(P):
        n = int(tiles.part_size[p])
        ids[p, :n] = tiles.part_start[p] + np.arange(n, dtype=np.int32)
    return ids, dmax


def _vertex_slots(tiles, V: int, dmax: int) -> np.ndarray:
    """(V,) int64: each vertex's row ``p * Dmax + v - part_start[p]`` in the
    flattened (P * Dmax) partition layout.  Refuses a tile set whose
    partitions are not contiguous vertex ranges covering [0, V) once, in
    order (every tiler's are): a vertex no partition holds would have no
    destination row to compute it."""
    start = np.asarray(tiles.part_start, np.int64)
    size = np.asarray(tiles.part_size, np.int64)
    if size.sum() != V or not np.array_equal(start, np.cumsum(size) - size):
        raise ValueError(
            f"the tile set's partitions do not cover the {V} vertices once, "
            f"in order: part_size sums to {int(size.sum())}, and part_start "
            "must be its prefix sum")
    return np.repeat(np.arange(size.size) * dmax - start, size) + np.arange(V)


def _upload(arr, device, dtype=None) -> Array:
    """Host array ``arr`` as a tensor on ``device``, counted."""
    t = torch.as_tensor(arr, dtype=dtype, device=device)
    spans.count("runner.h2d_bytes", t.nbytes)
    spans.count("runner.h2d_tensors")
    return t


def _tile_arrays(ts: TileSet, device: torch.device) -> Dict[str, Array]:
    """Per-tile index arrays as int64 tensors (indexing operands)."""
    return {k: _upload(getattr(ts, k), device).long()
            for k in ("src_ids", "edge_src", "edge_dst", "edge_gid", "n_src",
                      "n_edge", "part_id", "part_start")}


def _perm_operand(reordering, device) -> Optional[Dict[str, Array]]:
    """(order, rank) tensors; ``None`` for the identity."""
    if reordering is None or reordering.is_identity:
        return None
    return {k: _upload(getattr(reordering, k), device).long()
            for k in ("order", "rank")}


def _check_reorder_mode(expected: str, reordering) -> None:
    mode = "identity" if reordering is None else reordering.mode
    if mode != expected:
        raise ValueError(
            f"reordering mode {mode!r} does not match this runner's "
            f"compiled mode {expected!r}")


# ---- kernel operands and dispatch of a tile batch ---------------------------
# Both runners build the operands at bind, once a batch.

def tile_const(ts: TileSet, n_parts: int, device) -> Dict[str, Array]:
    """Kernel metadata for one tile batch: int32 partition ids, their
    runs ``part_ptr`` and FIRST/LAST flags, the partition presence
    mask, and for CSR tiles the int32 row pointers and column indices.
    ``part_ptr`` comes from the host array, so no launch syncs on it."""
    check_partition_major(ts.part_id)
    kc = dict(
        part_id=_upload(ts.part_id, device, torch.int32),
        part_ptr=_upload(partition_ptr(ts.part_id, n_parts), device),
        flags=_upload(tile_flags(ts.part_id), device),
        pmask=_upload(np.isin(np.arange(n_parts), ts.part_id), device))
    if ts.layout == "csr":
        kc["row_ptr"] = _upload(ts.row_ptr, device, torch.int32)
        kc["col"] = _upload(ts.edge_src, device, torch.int32)
    return kc


def _global_col(ta: Dict[str, Array]) -> Array:
    """(T, E) int32 global source row ``src_ids[t, edge_src[t, e]]`` of every
    edge slot, from the int64 tile arrays ``ta``: the columns through which
    the plan-walking kernels read the flat (V, F) store and edge blocks read
    stored source values.  Padded slots name some row too, and are never
    read."""
    return ta["src_ids"].gather(1, ta["edge_src"]).to(torch.int32)


def softmax_const(ts: TileSet, ta: Dict[str, Array], n_parts: int,
                  dmax: int, device) -> Dict[str, Array]:
    """Kernel metadata for the segment-softmax batch: the tile constants,
    the int32 edge lists, their global columns (from the int64 tile arrays
    ``ta``) and the batch's edge plan (built on the device, with the plan's
    host syncs)."""
    kc = tile_const(ts, n_parts, device)
    kc["col"] = _upload(ts.edge_src, device, torch.int32)
    kc["gcol"] = _global_col(ta)
    if ts.layout == "csr":
        kc["plan"] = csr_plan(kc["row_ptr"], kc["part_id"], n_parts,
                              ts.edge_src.shape[1])
    else:
        kc["edge_dst"] = _upload(ts.edge_dst, device, torch.int32)
        kc["n_edge"] = _upload(ts.n_edge, device, torch.int32)
        kc["plan"] = coo_plan(kc["edge_dst"], kc["n_edge"], kc["part_id"],
                              n_parts, dmax)
    return kc


def bucket_const(b: TileSet, ta: Dict[str, Array], with_adj: bool,
                 n_parts: int, dmax: int, device) -> Dict[str, Array]:
    """Per-bucket kernel metadata for the SpMM blocks: the global columns
    (from the edge arrays ``ta``), over CSR tiles the CSR plan (built on the
    device), over COO tiles for pure SpMM the dense adjacency (built on the
    device from ``ta``)."""
    kc = tile_const(b, n_parts, device)
    kc["gcol"] = _global_col(ta)
    if b.layout == "csr":
        kc["plan"] = csr_plan(kc["row_ptr"], kc["part_id"], n_parts,
                              b.edge_src.shape[1])
    elif with_adj:
        ones = torch.ones(ta["edge_src"].shape, device=device)
        kc["adj"] = tops.densify_edge_weights(
            ones, ta["edge_dst"], ta["edge_src"], ta["n_edge"],
            dmax=dmax, smax=b.s_max)
    return kc


def kernel_source(kc: Dict[str, Array], *, store: Optional[Array] = None,
                  replica: Optional[Array] = None) -> Tuple[Optional[Array], Array]:
    """A kernel's source operand paired with the columns that index it, the
    one place the two are matched: the flat (V, F) ``store`` with the
    batch's global columns ``kc["gcol"]`` (for the plan-walking kernels
    alone), or the (T, S, F) ``replica`` with its tile-local ``kc["col"]``
    (``None`` for the COO SpMM, which multiplies dense blocks).  Give one
    of the two."""
    if store is not None:
        return kc["gcol"], store.contiguous()
    return kc.get("col"), replica.contiguous()


def kernel_gather(kernel: str, layout: str, kc: Dict[str, Array],
                  ta: Dict[str, Array], src: Tuple[Optional[Array], Array],
                  vals: Optional[Array], n_parts: int, dmax: int) -> Array:
    """One kernel-tagged gather block over a tile batch: the source operand
    and its columns ``src`` (:func:`kernel_source`), per-edge ``vals``
    (T, E) — scores for the segment softmax, weights for weighted SpMM,
    ``None`` for pure SpMM — and the batch's operands ``kc``
    (:func:`softmax_const` / :func:`bucket_const`) and int64 tile arrays
    ``ta``.  Returns (P, Dmax, F); partitions without a tile in the batch
    are zero.

    The kernels have no backward, as the reference's have none: where
    autograd records and ``h`` or ``vals`` requires grad, this raises
    ``NotImplementedError`` on every device, as the reference's ``jax.grad``
    does through its kernel blocks."""
    col, h = src
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (h, vals)):
        raise NotImplementedError(
            f"the {kernel} gather block has no backward: a gradient cannot "
            "flow through a tile kernel; build the runner with "
            "kernel_dispatch=False to train through the scan path")
    if kernel == S.KERNEL_SEGMENT_SOFTMAX:
        # the kernel walks the edge plan and gathers each edge's source row
        # itself: no dense score block, no (T, E, F) value block; a
        # partition without a tile has only zero rows in the plan
        if layout == "csr":
            return tops.gat_aggregate_csr(kc["row_ptr"], col, vals, h,
                                          kc["part_id"], kc["flags"],
                                          n_parts=n_parts, plan=kc["plan"])
        return tops.gat_aggregate(kc["edge_dst"], kc["n_edge"], col, vals,
                                  h, kc["part_id"], kc["flags"], n_parts=n_parts,
                                  dmax=dmax, plan=kc["plan"])
    if vals is not None:                       # padded edge slots weigh 0
        emask = (torch.arange(vals.shape[1], device=vals.device)[None, :]
                 < ta["n_edge"][:, None])
        vals = torch.where(emask, vals, 0.0)
    if layout == "csr":
        w = torch.ones(ta["edge_src"].shape, device=h.device) if vals is None else vals
        return tops.spmm_csr(kc["row_ptr"], col, w, h, kc["part_id"],
                             kc["flags"], n_parts=n_parts, plan=kc["plan"])
    adj = kc["adj"] if vals is None else tops.densify_edge_weights(
        vals, ta["edge_dst"], ta["edge_src"], ta["n_edge"], dmax=dmax,
        smax=h.shape[-2])
    out = tops.spmm(adj, h, kc["part_id"], kc["flags"], n_parts=n_parts,
                    part_ptr=kc["part_ptr"])
    # partitions with no tile in the batch: the COO kernel (like the
    # reference's) leaves them unwritten
    return torch.where(kc["pmask"][:, None, None], out, 0.0)


def _edge_operands(ta: Dict[str, Array], pid: str, gcol: Array, V: int,
                   real: bool) -> Dict[str, Array]:
    """A batch's operands for an edge block, from its int64 tile arrays
    ``ta`` and its (T, E) global columns ``gcol`` (:func:`_global_col`):
    the tile arrays plus, for each edge, its global destination row
    ``dst_global``, global source row ``src_gid``, tile ``tile`` and
    padded-layout partition ``edge_part`` (``ta[pid]``).

    ``real=False`` keeps every (T, E) slot, with (T, 1) tile and partition
    indices for batched gathers and padded destinations clamped to V - 1.
    ``real=True`` keeps the real slots only, as flat (N,) vectors in (tile,
    slot) order; the listing syncs.  An edge block evaluated on them
    computes nothing on padded slots, whose values (read from rows the slot
    does not belong to) could be non-finite and would turn a zero cotangent
    into NaN."""
    if real:
        E = ta["edge_src"].shape[1]
        emask = (torch.arange(E, device=gcol.device)[None, :]
                 < ta["n_edge"][:, None])
        tile, slot = emask.nonzero(as_tuple=True)
        xs = {k: ta[k][tile, slot] for k in ("edge_src", "edge_dst", "edge_gid")}
        xs["src_ids"] = ta["src_ids"]
        xs["src_gid"] = gcol[tile, slot].long()     # int64, as the tile arrays
        xs["tile"] = by_tile = tile
    else:
        xs = dict(ta, src_gid=gcol)
        xs["tile"] = torch.arange(gcol.shape[0], device=gcol.device)[:, None]
        by_tile = slice(None), None     # (T,) per-tile arrays as (T, 1) views
    xs["edge_part"] = ta[pid][by_tile]
    dst = ta["part_start"][ta["part_id"]][by_tile] + xs["edge_dst"]
    xs["dst_global"] = dst if real else dst.clamp(max=V - 1)
    return xs


def _scan_edges(sp: S.ScheduledProgram, batches, pid: str,
                V: int) -> Tuple[Dict[str, Array], ...]:
    """Each batch's real edges (:func:`_edge_operands`), listed at bind
    for the scan gathers; none where the program has no scan gather.  The
    global columns are the batch's kernel operands' where it has them."""
    if not any(ph.scan_gathers() for ph in sp.phases):
        return ()
    return tuple(_edge_operands(ta, pid, kc["gcol"] if "gcol" in kc
                                else _global_col(ta), V, real=True)
                 for ta, kc in batches)


def _slots_to_vertices(V: int, *writes: Tuple[Array, Array]) -> Array:
    """The (V, F) vertex store of partition-slot rows: each ``(ids, rows)``
    pair scatters its (N, F) rows to the vertex ids (N,), later pairs over
    earlier ones, into a zeroed (V + 1, F) buffer whose sentinel row V,
    where invalid slots land, is dropped.  A vertex no slot names reads
    zero."""
    buf = writes[0][1].new_zeros((V + 1, writes[0][1].shape[-1]))
    for ids, rows in writes:
        buf[ids] = rows
    return buf[:V]


# ---- scan-gather accumulator semantics -------------------------------------
# Accumulators are flat (P * Dmax, dim): row part_id * Dmax + edge_dst.  The
# masking, mean-count and _NEG_INF-clamp rules match the reference's scan.

def _init_gather_acc(scan_gathers, n_rows: int, device) -> Dict[str, Array]:
    acc: Dict[str, Array] = {}
    for g in scan_gathers:
        cid, dim = g.acc.comm_id, g.acc.dim
        if g.acc.kind in ("sum", "mean"):
            acc[f"sum{cid}"] = torch.zeros((n_rows, dim), device=device)
            if g.acc.kind == "mean":
                acc[f"cnt{cid}"] = torch.zeros((n_rows, 1), device=device)
        else:
            acc[f"max{cid}"] = torch.full((n_rows, dim), _NEG_INF, device=device)
    return acc


def _gather_accumulate(acc: Dict[str, Array], g, v: Array,
                       dest: Array) -> None:
    """Fold the real edges' values ``v`` (N, dim) of every tile into the
    accumulator rows ``dest``, one batched scatter.  Sums add in place; a
    max replaces its accumulator, since autograd's backward of an ``amax``
    reads the accumulator as it was before the scatter."""
    cid = g.acc.comm_id
    if g.acc.kind in ("sum", "mean"):
        acc[f"sum{cid}"].index_add_(0, dest, v)
        if g.acc.kind == "mean":
            acc[f"cnt{cid}"].index_add_(0, dest, v.new_ones((v.shape[0], 1)))
    else:
        acc[f"max{cid}"] = acc[f"max{cid}"].scatter_reduce(
            0, dest[:, None].expand_as(v), v, "amax", include_self=True)


def _drain_gather_acc(acc: Dict[str, Array], g, P: int, dmax: int) -> Array:
    cid = g.acc.comm_id
    if g.acc.kind == "sum":
        out = acc[f"sum{cid}"]
    elif g.acc.kind == "mean":
        out = acc[f"sum{cid}"] / acc[f"cnt{cid}"].clamp_min(1.0)
    else:
        out = acc[f"max{cid}"]
    return out.view(P, dmax, -1)


class _Interpreter:
    """The per-tile interpretation of a scheduled program on one device:
    vertex blocks, edge blocks and one phase's gather blocks over a list of
    tile batches.  :class:`PipelinedRunner` drives one, and
    :class:`ShardedRunner` one per shard.

    ``vstore`` holds flat (V, F) values, ``pstore`` gather results and
    ``dstore`` dst-computed values in padded (P, Dmax, F) partition layout,
    and ``pending`` the ids drained but not yet in ``vstore``.  ``pid``
    names the tile array that indexes the padded layout (``part_id``, or a
    shard's ``local_pid``).  Destination replicas read their own
    partition's rows from the padded stores when the value is there: a
    shard never publishes values only its own destinations read."""

    def __init__(self, sp: S.ScheduledProgram, params: Dict,
                 vstore: Dict[int, Array], estore: Dict[int, Array],
                 n_vertices: int, device, *,
                 real: Sequence[Dict[str, Array]], pid: str = "part_id",
                 pending=frozenset(), count_src_rows: bool = False):
        self.sp = sp
        # each batch's real edges (:func:`_scan_edges`, listed at bind);
        # copied, since a run keeps its plans in them
        self._real = [dict(xs) for xs in real]
        self.count_src_rows = count_src_rows
        self.params = params
        self.vstore = vstore
        self.estore = estore
        self.pstore: Dict[int, Array] = {}
        self.dstore: Dict[int, Array] = {}
        self.pending = pending
        self.V = n_vertices
        self.device = device
        self.pid = pid

    def eval_vertex(self, rows, nodes, padded=False) -> Dict[int, Array]:
        """rows: vertex ids of any shape — (T, S) source slots or
        (P, Dmax) partition rows — or ``slice(None)``, every vertex in
        store order; ``padded=True`` (dst blocks) reads
        values still sitting in partition layout."""
        env: Dict[int, Array] = {}

        def lookup(nid):
            if nid in env:
                return env[nid]
            if padded:
                if nid in self.pstore:
                    return self.pstore[nid]
                if nid in self.dstore:
                    return self.dstore[nid]
            return self.vstore[nid][rows]

        for n in nodes:
            if n.id not in env and (n.id in self.vstore or n.id in self.pending
                                    or (padded and n.id in self.dstore)):
                # value already drained by an earlier dst block (layer
                # boundary): the source replica reads the stored rows
                # instead of recomputing the previous layer per tile
                continue
            if n.op == "output":
                env[n.id] = lookup(n.inputs[0])
            else:
                env[n.id] = apply_compute(n.op, n.attrs, self.params,
                                          [lookup(i) for i in n.inputs])
        return env

    def eval_source(self, rows, nodes) -> Dict[int, Array]:
        """A source block's vertex nodes over ``rows``: a batch's (T, S)
        source slots, or every vertex for ``rows=slice(None)``.  With
        ``count_src_rows``, counts the rows when a node ran
        (``runner.src_rows_computed``)."""
        env = self.eval_vertex(rows, nodes)
        if env and self.count_src_rows:
            spans.count("runner.src_rows_computed",
                        self.V if isinstance(rows, slice) else rows.numel())
        return env

    def edge_env(self, nodes, xs, senv):
        """Edge-block evaluation over every tile of ``xs`` at once: over
        its (T, E) slots or its real edges (:func:`_edge_operands`)."""
        eenv: Dict[int, Array] = {}
        # real edges' source rows of a stored value, gathered only when a
        # consumer other than the edge GEMM (which reads them in place)
        # asks: (V, F) table, (N,) rows
        lazy: Dict[int, Tuple[Array, Array]] = {}

        def elookup(nid):
            if nid in lazy:
                table, rows = lazy.pop(nid)
                eenv[nid] = table[rows]
            return (eenv[nid] if nid in eenv
                    else self.estore[nid][xs["edge_gid"]])

        for n in nodes:
            if n.op == "recvSrc":
                src_nid = self.sp.scatter_value_of[n.id]
                if src_nid not in senv:
                    # no (T, S) replica: each edge reads its global row
                    lazy[n.id] = (self.vstore[src_nid], xs["src_gid"])
                    continue
                base = self.src_value(senv, src_nid, xs["src_ids"])  # (T, S, F)
                eenv[n.id] = base[xs["tile"], xs["edge_src"]]
            elif n.op == "recvDst":
                src_nid = self.sp.scatter_value_of[n.id]
                local = self.pstore.get(src_nid, self.dstore.get(src_nid))
                if local is not None:
                    # the destination's own partition rows: no exchange
                    eenv[n.id] = local[xs["edge_part"], xs["edge_dst"]]
                else:
                    eenv[n.id] = self.vstore[src_nid][xs["dst_global"]]
            elif n.op == "bmm_edge":
                eenv[n.id] = self.bmm_edge(n, xs, elookup, lazy.get(n.inputs[0]))
            else:
                eenv[n.id] = apply_compute(n.op, n.attrs, self.params,
                                           [elookup(i) for i in n.inputs])
        return eenv, elookup

    def bmm_edge(self, n, xs, elookup, src=None) -> Array:
        """R-GCN's per-edge, type-selected product over the edges of
        ``xs``: the relation-grouped edge GEMM, on a plan made once per
        edge batch and type input (``runner.rel_plan``).  ``src``, a
        (table, rows) pair, gives the edges' source rows to read in place.
        Differentiable: its backward runs through the same plan."""
        types, w = elookup(n.inputs[1]), self.params[n.attrs["weight"]]
        x = src[0] if src is not None else elookup(n.inputs[0])
        key = ("rel_plan", n.inputs[1], src is not None)
        if key not in xs:          # src rows are xs["src_gid"] in every layer
            with spans.span("runner.rel_plan"):
                plan = rops.relation_plan(types, w.shape[0])
                xs[key] = plan if src is None else rops.read_rows(plan, src[1])
        plan = xs[key]
        if src is None:
            x = x.reshape(-1, x.shape[-1])
        spans.count("runner.edge_gemm_rows", plan.n_edges)
        return rops.relation_gemm(x, w, plan).reshape(*types.shape[:-1], w.shape[-1])

    def src_value(self, senv, nid, rows) -> Array:
        """The (T, S, F) replica of source value ``nid`` over a batch's
        slots ``rows``: computed per slot (``senv``) or gathered from the
        store.  With ``count_src_rows``, counts its rows
        (``runner.src_rows_replicated``)."""
        if self.count_src_rows:
            spans.count("runner.src_rows_replicated", rows.numel())
        return senv[nid] if nid in senv else self.vstore[nid][rows]

    def source_operand(self, senv, nid, rows, kc, plan_walk: bool):
        """A kernel's source operand and its columns (:func:`kernel_source`):
        the flat (V, F) store where the kernel walks an edge plan
        (``plan_walk``) and the value is stored, else the replica
        (:meth:`src_value`)."""
        if plan_walk and nid not in senv:
            return kernel_source(kc, store=self.vstore[nid])
        return kernel_source(kc, replica=self.src_value(senv, nid, rows))

    def edge_values(self, g, vid, xs, senv) -> Array:
        """(T, E) per-edge values ``vid`` of a kernel gather."""
        _, elookup = self.edge_env(g.edge_nodes, xs, senv)
        return elookup(vid)[..., 0].contiguous()

    def gather_blocks(self, phase, batches, softmax, n_parts: int, dmax: int,
                      layout: str, drain) -> None:
        """Every gather block of ``phase`` over the size buckets ``batches``
        ((tile arrays, kernel operands) pairs) and the unbucketed
        ``softmax`` batch; each result goes to ``pstore`` and then to
        ``drain(recv_id, value)``."""
        V, dev = self.V, self.device

        def done(g, val):
            self.pstore[g.acc.recv_id] = val
            drain(g.acc.recv_id, val)

        for g in phase.kernel_gathers():
            if g.kernel == S.KERNEL_SEGMENT_SOFTMAX:
                # per-edge scores and the source operand h of the
                # unbucketed batch
                ta0, kc0 = softmax
                xs0 = _edge_operands(ta0, self.pid, kc0["gcol"], V, real=False)
                senv = self.eval_source(xs0["src_ids"], phase.src.nodes)
                src = self.source_operand(senv, g.src_value_id, xs0["src_ids"],
                                          kc0, True)
                scores = self.edge_values(g, g.score_id, xs0, senv)
                done(g, kernel_gather(g.kernel, layout, kc0, ta0, src, scores,
                                      n_parts, dmax))
                continue
            # SpMM variants: one kernel call per size bucket, partition
            # outputs summed into a shared (P, Dmax, F) buffer
            total = torch.zeros((n_parts, dmax, g.acc.dim), device=dev)
            for ta, kc in batches:
                senv = self.eval_source(ta["src_ids"], phase.src.nodes)
                src = self.source_operand(senv, g.src_value_id, ta["src_ids"],
                                          kc, layout == "csr")
                w = (None if g.kernel == S.KERNEL_SPMM else
                     self.edge_values(g, g.weight_id, _edge_operands(
                         ta, self.pid, kc["gcol"], V, real=False), senv))
                total += kernel_gather(g.kernel, layout, kc, ta, src, w,
                                       n_parts, dmax)
            done(g, total)

        # scan-tagged gathers: the edge block on each bucket's real edges,
        # one batched scatter per bucket into accumulators shared across
        # buckets
        scan_gathers = phase.scan_gathers()
        if scan_gathers:
            acc = _init_gather_acc(scan_gathers, n_parts * dmax, dev)
            for xs in self._real:
                senv = self.eval_source(xs["src_ids"], phase.src.nodes)
                _, elookup = self.edge_env(phase.edge.nodes, xs, senv)
                dest = xs["edge_part"] * dmax + xs["edge_dst"]
                for g in scan_gathers:
                    _gather_accumulate(acc, g, elookup(g.acc.value_id), dest)
            for g in scan_gathers:
                done(g, _drain_gather_acc(acc, g, n_parts, dmax))


class PipelinedRunner:
    """Interprets one compiled model's scheduled program over a tile set.

    ``kernel_dispatch`` selects the scheduled program variant: ``True`` (the
    default) routes pattern-matched gather blocks through the CUDA tile
    kernels, ``False`` interprets the pure multi-phase scan schedule.

    A runner depends only on its *structure signature* — the scheduled
    program plus the tile-set shapes (``signature`` property) — never on
    the concrete edge lists: :meth:`bind` derives the device operands of a
    same-signature tile set and :meth:`run_with` executes them without a
    rebuild, which is what the serving-layer program cache amortizes.

    ``device`` is ``cuda`` unless the caller names another (the tests pass
    ``"cpu"``, where the kernels' plain versions run).

    Autograd records a call when a tensor given requires grad.  The scan
    path differentiates; a kernel-tagged gather refuses a gradient
    (:func:`kernel_gather`), so a runner that trains is built with
    ``kernel_dispatch=False``.  Serving runs under inference mode.

    A call that autograd does not record evaluates each phase's source
    block once over the flat (V, F) vertex store where V is at most the
    padded source rows of the batches (``bind``'s count); else, and
    always under autograd, per batch over its (T, S_max) source slots.
    """

    def __init__(self, compiled: C.CompiledGNN, graph: Graph, tiles,
                 kernel_dispatch: bool = True, reordering=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve(device)
        self.sp: S.ScheduledProgram = compiled.schedule(kernel_dispatch)
        self.graph = graph
        self.tiles = tiles
        self.layout = getattr(tiles, "layout", "coo")
        # ``graph`` (and the tiles) live in reordered vertex space when a
        # non-identity ``reordering`` is given; the runner permutes request
        # inputs in and outputs back, so callers stay in original ids
        self.reordering = reordering
        self.reorder_mode = ("identity" if reordering is None
                             else reordering.mode)
        part_ids_pad, self.dmax = _padded_partition_ids(tiles)
        V = graph.n_vertices
        self._safe_pad_ids = torch.as_tensor(
            part_ids_pad, device=self.device).long().clamp(max=V - 1)
        # the signature holds part_start / part_size, so every tile set
        # bind accepts has this map
        self._slot_of = torch.as_tensor(_vertex_slots(tiles, V, self.dmax),
                                        device=self.device)
        self._kernels = {g.kernel for ph in self.sp.phases for g in ph.gathers}
        # the graph's relations that have an edge, where an edge GEMM runs
        typed = graph.edge_type is not None and any(
            n.op == "bmm_edge" for ph in self.sp.phases for n in ph.edge.nodes)
        self._rel_groups = (int(np.count_nonzero(np.bincount(graph.edge_type)))
                            if typed else 0)
        self._signature = (self.sp.structure_signature(),
                           tiles.shape_signature(), self.reorder_mode)
        self._operands: Optional[Tuple] = None   # lazy bind of ctor tiles

    @property
    def signature(self) -> Tuple:
        """(program, tile-set) structural identity this runner serves."""
        return self._signature

    # ------------------------------------------------------------------ bind
    def bind(self, tiles, reordering=None) -> Tuple:
        """Device operands (tile arrays + kernel constants + permutation +
        the scan gathers' real edges) for
        a tile set structurally identical to the construction one — the
        per-request rebind step the serving cache runs instead of a
        rebuild.  ``reordering`` must realize the runner's reorder mode.
        The last operand counts the source rows a run computes over:
        (T x S_max, sum of ``n_src``) summed over the batches that run."""
        if tiles.shape_signature() != self.tiles.shape_signature():
            raise ValueError(
                "tile set is not structurally identical to this runner's: "
                f"{tiles.shape_signature()} != {self.tiles.shape_signature()}")
        _check_reorder_mode(self.reorder_mode, reordering)
        with spans.span("runner.bind"):
            return self._bind(tiles, reordering)

    def _bind(self, tiles, reordering) -> Tuple:
        buckets: List[TileSet] = (
            list(tiles.buckets) if isinstance(tiles, BucketedTileSet) else [tiles])
        tas = tuple(_tile_arrays(b, self.device) for b in buckets)
        if self._kernels & {S.KERNEL_SPMM, S.KERNEL_SPMM_WEIGHTED}:
            P, with_adj = self.tiles.n_dst_parts, S.KERNEL_SPMM in self._kernels
            with spans.span("runner.plan"):
                kcs = tuple(bucket_const(b, ta, with_adj, P, self.dmax,
                                         self.device)
                            for b, ta in zip(buckets, tas))
        else:
            kcs = tuple({} for _ in buckets)
        # the source blocks a run computes over: every bucket's, for the
        # SpMM and scan gathers, and the softmax batch's
        ran = buckets if self._kernels - {S.KERNEL_SEGMENT_SOFTMAX} else []
        # the online-softmax state cannot be merged across buckets, so the
        # segment-softmax block always runs over the unbucketed tile batch
        ta0 = kc0 = None
        if S.KERNEL_SEGMENT_SOFTMAX in self._kernels:
            st = tiles.source if isinstance(tiles, BucketedTileSet) else tiles
            ta0 = _tile_arrays(st, self.device)
            with spans.span("runner.plan"):
                kc0 = softmax_const(st, ta0, self.tiles.n_dst_parts,
                                    self.dmax, self.device)
            ran = ran + [st]
        rows = (sum(b.src_ids.size for b in ran),
                sum(int(b.n_src.sum()) for b in ran))
        reals = _scan_edges(self.sp, zip(tas, kcs), "part_id",
                            self.graph.n_vertices)
        return (tas, kcs, ta0, kc0, _perm_operand(reordering, self.device),
                reals, rows)

    # ------------------------------------------------------------------ run
    def __call__(self, inputs: Dict, params: Dict,
                 operands: Optional[Tuple] = None) -> List[Array]:
        if operands is None:
            if self._operands is None:
                self._operands = self.bind(self.tiles, self.reordering)
            operands = self._operands
        inputs = {k: to_device(v, self.device) for k, v in inputs.items()}
        params = {k: to_device(v, self.device) for k, v in params.items()}
        *ops, (padded, real) = operands
        V = self.graph.n_vertices
        # a source block costs V rows evaluated flat, ``padded`` rows
        # evaluated per slot: flat unless the vertices outnumber the slots,
        # as where most of them source no tile.  Under autograd the blocks
        # stay per slot, so gradients sum in the reference's per-slot order
        # (training's trajectory parity with the reference rests on it)
        records = torch.is_grad_enabled() and any(
            t.requires_grad for t in (*inputs.values(), *params.values()))
        with spans.span("runner.run"):
            spans.count("runner.src_rows_padded", padded)
            spans.count("runner.src_rows_real", real)
            spans.count("runner.vertices", V)
            spans.count("runner.edges", self.graph.n_edges)
            # present in every run: 0 where every source operand is flat
            spans.count("runner.src_rows_replicated", 0)
            if self._rel_groups:
                spans.count("runner.rel_groups", self._rel_groups)
            return self._run(inputs, params, *ops,
                             V <= padded and not records)

    def run_with(self, tiles, inputs: Dict, params: Dict,
                 reordering=None) -> List[Array]:
        """Execute a different same-signature tile set through this runner
        (no rebuild: operand shapes are identical by contract)."""
        return self(inputs, params, operands=self.bind(tiles, reordering))

    def unpad(self, val: Array) -> Array:
        """(P, Dmax, d) partition-padded -> (V, d) vertex store: one row
        gather through the vertex-to-slot map, which never reads an invalid
        slot (``runner.unpad_rows``: V a gather)."""
        spans.count("runner.unpad_rows", self._slot_of.numel())
        return val.reshape(-1, val.shape[-1]).index_select(0, self._slot_of)

    def _run(self, inputs, params, tas, kcs, ta0, kc0, perm, reals,
             flat: bool) -> List[Array]:
        """One pass.  ``flat``: evaluate each phase's source block once over
        the flat (V, F) store before its tile work, so the batches only
        gather its rows; else per batch over the (T, S_max) slots."""
        sp = self.sp
        V = self.graph.n_vertices
        P, dmax = self.tiles.n_dst_parts, self.dmax
        dev = self.device

        if perm is not None:
            # requests arrive in original vertex order; the tiles live in
            # reordered space — permute vertex features in, outputs back
            inputs = dict(inputs)
            for name in {name for _, name in sp.vertex_inputs}:
                inputs[name] = inputs[name][perm["order"]]

        vstore: Dict[int, Array] = {nid: inputs[name]
                                    for nid, name in sp.vertex_inputs}
        estore: Dict[int, Array] = {nid: inputs[name]
                                    for nid, name in sp.edge_inputs}

        # ---- gather-drain fusion across phase/layer boundaries -------------
        # A gather result lands in padded (P, Dmax, F) partition layout.  The
        # next phase's dst block reads it in exactly that layout, so keeping
        # it in ``pstore`` skips the unpad + re-gather round trip.
        # Only values the tile-side paths read — src recompute, edge
        # recvSrc/recvDst, kernel X operands, outputs — are published to the
        # flat (V, F) vertex store.
        tile_side_reads = set(sp.outputs)
        tile_side_reads.update(sp.scatter_value_of.values())
        for ph in sp.phases:
            for n in ph.src.nodes:
                tile_side_reads.update(n.inputs)
            for gb in ph.gathers:
                if gb.src_value_id is not None:
                    tile_side_reads.add(gb.src_value_id)
        it = _Interpreter(sp, params, vstore, estore, V, dev, real=reals,
                          count_src_rows=True)
        batches = list(zip(tas, kcs))

        def publish_gather(recv_id, padded_val):
            if recv_id in tile_side_reads:
                vstore[recv_id] = self.unpad(padded_val)

        for phase in sp.phases:
            # ---- destination block (vectorized over partitions; gather
            # results of the previous phase are consumed directly in padded
            # layout — the drain of layer l fuses into layer l+1's dst work)
            if phase.dst.store_ids:
                denv = it.eval_vertex(self._safe_pad_ids, phase.dst.nodes,
                                      padded=True)
                for nid in phase.dst.store_ids:
                    vstore[nid] = self.unpad(denv[nid])
            if phase.has_tile_work:
                if flat:
                    # nodes an earlier phase stored are not recomputed, and
                    # gather_blocks finds every node of the block stored
                    vstore.update(it.eval_source(slice(None), phase.src.nodes))
                it.gather_blocks(phase, batches, (ta0, kc0), P, dmax,
                                 self.layout, publish_gather)

        outs = [vstore[o] for o in sp.outputs]
        if perm is not None:
            outs = [o[perm["rank"]] for o in outs]
        return outs


def run_pipelined(compiled: C.CompiledGNN, graph: Graph, tiles,
                  inputs: Dict, params: Dict, kernel_dispatch: bool = True,
                  reordering=None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> List[Array]:
    """Build a :class:`PipelinedRunner` and run it once."""
    return PipelinedRunner(compiled, graph, tiles,
                           kernel_dispatch=kernel_dispatch,
                           reordering=reordering, device=device)(inputs, params)


# ---------------------------------------------------------------------------
# sharded execution: one ScheduledProgram data-parallel over dst partitions
# ---------------------------------------------------------------------------

def _quantize_cap(n: int) -> int:
    """Round a per-shard tile capacity up to the next power of two (serving:
    small per-request variance in shard tile counts must map onto one
    compiled shape)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _cap(counts: Sequence[int], quantize: bool) -> int:
    """The capacity that holds the largest of the per-shard ``counts`` (at
    least 1), power-of-two quantized under ``quantize``."""
    cap = max(1, max(counts))
    return _quantize_cap(cap) if quantize else cap


def _shard_tile_counts(tiles, plan: ShardPlan) -> List[List[int]]:
    """Per bucket, per shard: number of real (n_edge > 0) tiles assigned."""
    buckets: List[TileSet] = (list(tiles.buckets)
                              if isinstance(tiles, BucketedTileSet) else [tiles])
    out = []
    for b in buckets:
        shard = plan.shard_of_part[b.part_id]
        real = b.n_edge > 0
        out.append([int(np.sum(real & (shard == k)))
                    for k in range(plan.n_shards)])
    return out


def _source_tileset(tiles) -> TileSet:
    return tiles.source if isinstance(tiles, BucketedTileSet) else tiles


def _exchange_cap(tiles, plan: ShardPlan, quantize_tile_cap: bool) -> int:
    """Static send-buffer capacity of the restricted boundary exchange:
    the largest per-shard send set (rows a shard owns that remote shards'
    gather blocks read), power-of-two quantized under serving's cap
    quantization so small per-request variance shares one compiled shape."""
    return _cap([exchange_sets(tiles, plan).max_send], quantize_tile_cap)


def shard_layout_signature(tiles, n_devices: int, mode: str = "cost",
                           quantize_tile_cap: bool = False,
                           kernel_dispatch: bool = False,
                           kernels: Tuple[str, ...] = (),
                           model_axis: int = 1) -> Tuple:
    """Shape identity of the sharded execution layout — everything a
    :class:`ShardedRunner` compilation depends on beyond the program and
    tile-set signatures.  Cheap (pure numpy); the serving engine calls it
    per request to key the program cache, so two requests share a warm
    sharded runner iff their shard layouts realize identical shapes.

    ``kernel_dispatch`` (and, when it is on, the program's kernel tags) is
    part of the identity: a scan-scheduled compilation must never alias a
    kernel-dispatched one, and the segment-softmax kernel adds a per-shard
    capacity for the unbucketed tile batch that scan programs don't have.
    Multi-shard layouts append the restricted-exchange send capacity
    (:func:`_exchange_cap`); ``model_axis`` names the 2-D mesh's feature
    axis width — a different feature split never aliases."""
    plan = plan_shards(tiles, n_devices, mode=mode)
    caps = [_cap(counts, quantize_tile_cap)
            for counts in _shard_tile_counts(tiles, plan)]
    if kernel_dispatch and S.KERNEL_SEGMENT_SOFTMAX in kernels:
        caps.append(_cap(_shard_tile_counts(_source_tileset(tiles), plan)[0],
                         quantize_tile_cap))
    if n_devices > 1:
        caps.append(_exchange_cap(tiles, plan, quantize_tile_cap))
    return ("shardlayout", n_devices, mode, int(model_axis),
            plan.n_local_parts, tuple(caps), bool(kernel_dispatch))


def _shard_partition_ids(plan: ShardPlan, part_start: np.ndarray,
                         part_size: np.ndarray, dmax: int,
                         n_vertices: int) -> np.ndarray:
    """(K, P_loc, Dmax) global vertex id per (shard, local slot, offset);
    invalid slots carry the sentinel ``n_vertices``."""
    K, P_loc = plan.n_shards, plan.n_local_parts
    ids = np.full((K, P_loc, dmax), n_vertices, np.int32)
    for k, parts in enumerate(plan.parts_of_shard):
        for j, p in enumerate(parts):
            n = int(part_size[p])
            ids[k, j, :n] = int(part_start[p]) + np.arange(n, dtype=np.int32)
    return ids


def _shard_layout(tiles, plan: ShardPlan, quantize_tile_cap: bool,
                  kernels: frozenset = frozenset()
                  ) -> Tuple[Dict, Dict, Tuple]:
    """Build the per-shard operand arrays (numpy) of a sharded run.

    Returns ``(shard_ops, repl_ops, caps)``: ``shard_ops`` arrays carry a
    leading shard axis (row ``k`` = shard ``k``'s slice), ``repl_ops`` are
    replicated tables.  Per bucket, each shard receives its partitions' real
    tiles in the bucket's partition-major order (bucket order preserved) and
    is padded to a common capacity with zero-edge filler rows.  Filler rows
    repeat the shard's last real ``part_id``/``local_pid``
    (:func:`~repro_torch.core.tiling.pad_tileset`'s convention), so they
    extend that partition's run with empty tiles instead of opening a run
    of another partition.  ``pmask`` marks the local slots that own a real
    tile of the bucket (a shard with no real tile has filler rows at slot 0
    and an all-false mask).

    When ``kernels`` names the segment-softmax kernel, a ``softmax`` entry
    lays out the *unbucketed* tile batch per shard (online-softmax state
    cannot be merged across buckets).  All shapes are a pure function of
    the tile-set signature, the plan shape and the caps:
    :meth:`ShardedRunner.bind` rebuilds them for any structurally-identical
    tile set, and the runner turns each shard's slice into the same kernel
    operands :class:`PipelinedRunner` builds, over ``P_loc`` local slots.
    """
    buckets: List[TileSet] = (list(tiles.buckets)
                              if isinstance(tiles, BucketedTileSet) else [tiles])
    K, P_loc = plan.n_shards, plan.n_local_parts
    dmax = int(tiles.part_size.max())

    def shard_stack(b: TileSet, cap: int) -> Dict:
        shard = plan.shard_of_part[b.part_id]
        sel_of = [np.nonzero((shard == k) & (b.n_edge > 0))[0]
                  for k in range(K)]

        def stack(a: np.ndarray, fill=0) -> np.ndarray:
            out = np.full((K, cap) + a.shape[1:], fill, a.dtype)
            for k, sel in enumerate(sel_of):
                out[k, :len(sel)] = a[sel]
            return out

        ops = dict(
            src_ids=stack(b.src_ids), edge_src=stack(b.edge_src),
            edge_dst=stack(b.edge_dst), edge_gid=stack(b.edge_gid),
            n_src=stack(b.n_src), n_edge=stack(b.n_edge),
            part_id=stack(b.part_id),
            local_pid=stack(plan.local_slot_of_part[b.part_id].astype(np.int32)),
        )
        if b.row_ptr is not None:
            # filler rows keep the all-zero pointer table: every CSR row run
            # is [0, 0), the correct empty-tile contribution
            ops["row_ptr"] = stack(b.row_ptr)
        pmask = np.zeros((K, P_loc), bool)
        for k, sel in enumerate(sel_of):
            # filler rows extend the last real partition run (see docstring)
            if 0 < len(sel) < cap:
                ops["part_id"][k, len(sel):] = ops["part_id"][k, len(sel) - 1]
                ops["local_pid"][k, len(sel):] = ops["local_pid"][k, len(sel) - 1]
            pmask[k, ops["local_pid"][k, :len(sel)]] = True
        ops["pmask"] = pmask
        return ops

    caps = [_cap(counts, quantize_tile_cap)
            for counts in _shard_tile_counts(tiles, plan)]
    bucket_ops = [shard_stack(b, cap) for b, cap in zip(buckets, caps)]

    pad_ids = _shard_partition_ids(plan, tiles.part_start, tiles.part_size,
                                   dmax, tiles.n_vertices)
    shard_ops = {"pad_ids": pad_ids, "buckets": bucket_ops}
    if S.KERNEL_SEGMENT_SOFTMAX in kernels:
        st = _source_tileset(tiles)
        cap0 = _cap(_shard_tile_counts(st, plan)[0], quantize_tile_cap)
        caps.append(cap0)
        shard_ops["softmax"] = shard_stack(st, cap0)
    repl_ops = {"full_pad_ids": pad_ids.reshape(-1).copy()}
    if K > 1:
        # restricted-exchange send sets: per shard, the flat local-buffer
        # slots of the rows it owns that remote shards' gather blocks read,
        # and the replicated global-id table the receive scatter uses
        # (sentinel n_vertices rows are dropped).  Interior boundary
        # publishes all-gather only this compacted buffer.
        ex = exchange_sets(tiles, plan)
        ecap = _cap([ex.max_send], quantize_tile_cap)
        caps.append(ecap)
        part_start = np.asarray(tiles.part_start)
        send_slots = np.zeros((K, ecap), np.int32)
        send_ids = np.full((K, ecap), tiles.n_vertices, np.int32)
        for k, rows in enumerate(ex.send_rows):
            part = np.searchsorted(part_start, rows, side="right") - 1
            slots = (plan.local_slot_of_part[part].astype(np.int64) * dmax
                     + (rows - part_start[part]))
            send_slots[k, :len(rows)] = slots.astype(np.int32)
            send_ids[k, :len(rows)] = rows.astype(np.int32)
        shard_ops["send_slots"] = send_slots
        repl_ops["send_ids"] = send_ids.reshape(-1).copy()
    return shard_ops, repl_ops, tuple(caps)


def _shard_tileset(b: TileSet, stk: Dict[str, np.ndarray], k: int,
                   plan: ShardPlan) -> TileSet:
    """Shard ``k``'s slice of bucket ``b`` (filler rows included) as a
    :class:`TileSet` over its ``P_loc`` local partition slots: the kernel
    operand functions take it as they take a whole tile set."""
    P_loc = plan.n_local_parts
    parts = plan.parts_of_shard[k]
    part_start = np.zeros(P_loc, np.int32)
    part_size = np.zeros(P_loc, np.int32)
    part_start[:len(parts)] = np.asarray(b.part_start)[parts]
    part_size[:len(parts)] = np.asarray(b.part_size)[parts]
    return dataclasses.replace(
        b, src_ids=stk["src_ids"][k], edge_src=stk["edge_src"][k],
        edge_dst=stk["edge_dst"][k], edge_gid=stk["edge_gid"][k],
        n_src=stk["n_src"][k], n_edge=stk["n_edge"][k],
        part_id=stk["local_pid"][k], part_start=part_start,
        part_size=part_size, n_dst_parts=P_loc,
        row_ptr=stk["row_ptr"][k] if "row_ptr" in stk else None)


class ShardedRunner:
    """Data-parallel execution of one :class:`~repro_torch.core.schedule
    .ScheduledProgram` over a mesh of ``n_devices`` shards.

    Each shard owns whole destination partitions (a :class:`~repro_torch
    .core.tiling.ShardPlan`), so every gather accumulator and every drained
    partition-layout value stays shard-local; the only cross-shard dataflow
    is the layer-boundary read of drained source values, exchanged by ONE
    :meth:`~repro_torch.core.exchange.ShardMesh.all_gather` per boundary
    (values read back through destination replicas — GAT's softmax
    ``recvDst`` statistics, for instance — never leave their shard).

    ``mesh`` is the :class:`~repro_torch.core.exchange.ShardMesh` to run
    on; without one, one process drives a mesh over ``devices``, an ordered
    list (shard ``k``, model rank ``m`` on ``devices[k * model_axis + m]``;
    the visible cards by default, never repeated silently), each shard's
    work on its own device.  Logical shards on one card are an explicit list
    that names it K times.  Under a process-group mesh
    (:meth:`~repro_torch.core.exchange.ShardMesh.from_process_group`) each
    rank builds this runner and calls it with the same inputs, runs only its
    own shard, and returns what the one-process run returns: the final
    exchange ships the outputs' full layout to every shard.  Every rank
    derives the :class:`~repro_torch.core.tiling.ShardPlan` and the shard
    layout from the same numpy tiles on its own, so the planning must be
    deterministic across processes — it is (LPT and the mincut refinement
    break ties by index, with no randomness or hash order); a plan that
    differed between ranks would exchange mismatched rows.  ``device`` is
    where outputs are returned (the first local shard's device unless
    named).

    ``kernel_dispatch`` selects the scheduled program variant exactly as in
    :class:`PipelinedRunner`: ``True`` routes pattern-matched gather blocks
    through the CUDA tile kernels inside each shard — each shard's slice of
    a bucket gets the operands :class:`PipelinedRunner` builds, over its
    ``P_loc`` local partition slots — and ``False`` interprets the scan
    schedule.

    ``mode`` picks the partition assignment (``"cost"``: LPT-balanced padded
    edge cost; ``"mincut"``: LPT seed + deterministic KL-style refinement
    minimizing cross-shard source reads; ``"contiguous"``: even ranges —
    deterministic across requests, what serving uses),
    ``quantize_tile_cap=True`` rounds per-shard tile capacities to powers of
    two so structurally-similar requests share one operand layout.

    Interior layer boundaries use a *neighbor-restricted* exchange: each
    shard all-gathers only its compacted send buffer — the rows remote
    shards' gather blocks actually read, a static per-shard set derived from
    the plan (:func:`~repro_torch.core.tiling.exchange_sets`) — and scatters
    its own partitions' rows locally.  Only the final output drain (whose
    results must come out replicated) ships the full padded layout.
    :func:`~repro_torch.core.analysis.hazards.verify_exchange` proves
    coverage statically.

    ``model_axis=M > 1`` grows the mesh to 2-D over ``n_devices * M``
    devices: compute is replicated over the model axis (the runner computes
    each shard once, on its rank-0 device) while every boundary exchange
    ships each rank's ``ceil(W / M)`` slice over the shards axis and
    reassembles full width.

    The reference counts the all-gathers of its compiled HLO (its
    ``lower_text``); here :attr:`mesh` counts the exchange calls
    (``mesh.collectives``).  XLA's combiner folds a phase's gather drain and
    the next phase's dst drain, which have no tile work between them, into
    one all-gather; this runner defers a drain to the next tile work (or
    the end) and ships every drain queued by then in one call, so a pass
    makes :func:`~repro_torch.core.analysis.hazards.exchange_census`'s
    ``n_collectives`` calls.  The deferral is exact: a dst block reads
    drained values from the shard-local padded stores.

    Like :class:`PipelinedRunner`, a runner depends only on
    :attr:`signature`; :meth:`bind`/:meth:`run_with` re-derive operands for
    a different same-signature tile set without a rebuild.
    """

    def __init__(self, compiled: C.CompiledGNN, graph: Graph, tiles,
                 n_devices: Optional[int] = None, *, mode: str = "cost",
                 quantize_tile_cap: bool = False,
                 devices: Optional[Sequence] = None,
                 kernel_dispatch: bool = True,
                 reordering=None, model_axis: int = 1,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[ShardMesh] = None):
        if mesh is None:
            devices = (default_devices(device) if devices is None
                       else [torch.device(d) for d in devices])
            if n_devices is None:
                n_devices = max(1, len(devices) // max(1, model_axis))
            mesh = ShardMesh(devices, n_devices, model_axis)   # validates
        elif ((n_devices not in (None, mesh.n_shards))
              or model_axis not in (1, mesh.model_axis)):
            raise ValueError(
                f"n_devices={n_devices}, model_axis={model_axis} disagree "
                f"with the {mesh.n_shards} x {mesh.model_axis} mesh")
        n_devices, model_axis = mesh.n_shards, mesh.model_axis
        self.mesh = mesh
        self.device = (resolve(device) if device is not None
                       else mesh.shard_device(mesh.local_shards[0]))
        self.kernel_dispatch = bool(kernel_dispatch)
        self.sp: S.ScheduledProgram = compiled.schedule(self.kernel_dispatch)
        self.graph = graph
        self.tiles = tiles
        self.layout = getattr(tiles, "layout", "coo")
        self.mode = mode
        self.quantize_tile_cap = quantize_tile_cap
        self.n_devices = n_devices
        self.model_axis = int(model_axis)
        # like PipelinedRunner: graph/tiles in reordered space, requests in
        # original ids; the (order, rank) permutation is a replicated
        # operand, so it adds no exchange
        self.reordering = reordering
        self.reorder_mode = ("identity" if reordering is None
                             else reordering.mode)
        self._kernels = frozenset(g.kernel for ph in self.sp.phases
                                  for g in ph.gathers)
        self.plan = plan_shards(tiles, n_devices, mode=mode)
        self.dmax = int(tiles.part_size.max())
        self._layout_np = _shard_layout(tiles, self.plan, quantize_tile_cap,
                                        self._kernels)
        self.caps = self._layout_np[2]
        self._publish = self._publish_ids()
        self._signature = ("sharded", n_devices, mode, self.plan.n_local_parts,
                           self.caps, self.kernel_dispatch,
                           self.sp.structure_signature(),
                           tiles.shape_signature(), self.reorder_mode,
                           self.model_axis)
        self._operands: Optional[List[Dict]] = None

    # ------------------------------------------------------------- identity
    @property
    def signature(self) -> Tuple:
        """(mesh, layout, program, tile-set) identity this runner serves —
        includes ``n_devices`` so a serving cache can never alias a sharded
        program with a single-device one (or across mesh sizes)."""
        return self._signature

    def _publish_ids(self) -> set:
        """Vertex node ids whose values must be exchanged into the
        replicated flat store: tile-side source reads (and the outputs) of
        values that are *gather-tainted* — transitively derived from a
        gather result, i.e. carrying partition-owned aggregated state.

        Untainted values (pure functions of replicated inputs, like GAT's
        ``h = x @ W``) are recomputed by the source replicas per tile —
        bitwise the same rows, no collective.  Values consumed only through
        destination replicas (``recvDst``) or later dst blocks stay
        shard-local either way, so each layer boundary drains exactly one
        all-gather."""
        sp = self.sp
        node_op: Dict[int, str] = {}
        vnodes = []
        for seg in sp.prog.segments:
            for n in seg.nodes.values():
                node_op[n.id] = n.op
        for seg in sp.prog.vertex_segments():
            vnodes.extend(seg.toposort())
        tainted: set = set()
        for n in vnodes:
            if n.op == "recvInEdge" or any(i in tainted for i in n.inputs):
                tainted.add(n.id)

        reads = set(sp.outputs)
        for ph in sp.phases:
            for n in ph.src.nodes:
                reads.update(n.inputs)
            for g in ph.gathers:
                if g.src_value_id is not None:
                    reads.add(g.src_value_id)
        for rnid, vnid in sp.scatter_value_of.items():
            if node_op.get(rnid) == "recvSrc":
                reads.add(vnid)
        pub = (reads & tainted) | set(sp.outputs)
        return pub - {nid for nid, _ in sp.vertex_inputs}

    # ------------------------------------------------------------------ bind
    def bind(self, tiles, reordering=None) -> List[Dict]:
        """Per-shard device operands for a tile set structurally identical
        to the construction one (same tile-set signature AND same realized
        shard layout shapes) — the per-request rebind step of the serving
        cache.  ``reordering`` must realize the runner's reorder mode."""
        if tiles.shape_signature() != self.tiles.shape_signature():
            raise ValueError(
                "tile set is not structurally identical to this runner's: "
                f"{tiles.shape_signature()} != {self.tiles.shape_signature()}")
        _check_reorder_mode(self.reorder_mode, reordering)
        plan = plan_shards(tiles, self.n_devices, mode=self.mode)
        if plan.n_local_parts != self.plan.n_local_parts:
            raise ValueError(
                f"shard layout mismatch: {plan.n_local_parts} local "
                f"partition slots != {self.plan.n_local_parts}")
        layout = (self._layout_np if tiles is self.tiles else
                  _shard_layout(tiles, plan, self.quantize_tile_cap,
                                self._kernels))
        if layout[2] != self.caps:
            raise ValueError(
                f"shard tile capacities changed: {layout[2]} != {self.caps}")
        return self._device_operands(tiles, plan, *layout[:2], reordering)

    def _device_operands(self, tiles, plan: ShardPlan, ops: Dict, repl: Dict,
                         reordering) -> List[Dict]:
        """Shard ``k``'s operands on its device: the (P_loc, Dmax) vertex
        ids of its slots, per bucket the int64 tile arrays and the kernel
        operands of its slice, the softmax batch, the scan gathers' real
        edges, its send slots and the replicated tables (one copy a
        device)."""
        buckets: List[TileSet] = (list(tiles.buckets)
                                  if isinstance(tiles, BucketedTileSet)
                                  else [tiles])
        P_loc, dmax = plan.n_local_parts, self.dmax
        spmm = self._kernels & {S.KERNEL_SPMM, S.KERNEL_SPMM_WEIGHTED}
        with_adj = S.KERNEL_SPMM in self._kernels
        if reordering is not None and not reordering.is_identity:
            repl = dict(repl, order=reordering.order, rank=reordering.rank)
        repl_on: Dict[torch.device, Dict[str, Array]] = {}

        def shard_batch(stk: Dict, k: int, dev) -> Dict[str, Array]:
            ta = {key: torch.as_tensor(stk[key][k], device=dev).long()
                  for key in ("src_ids", "edge_src", "edge_dst", "edge_gid",
                              "n_edge", "part_id", "local_pid")}
            ta["part_start"] = torch.as_tensor(tiles.part_start,
                                               device=dev).long()
            return ta

        def real_pmask(kc: Dict, stk: Dict, k: int, dev) -> Dict:
            # presence from the real tiles only: the filler rows of a shard
            # with no real tile sit at slot 0
            kc["pmask"] = torch.as_tensor(stk["pmask"][k], device=dev)
            return kc

        out = []
        for k in self.mesh.local_shards:
            dev = self.mesh.shard_device(k)
            if dev not in repl_on:
                repl_on[dev] = {key: torch.as_tensor(v, device=dev).long()
                                for key, v in repl.items()}
            sops = dict(repl_on[dev])
            sops["pad_ids"] = torch.as_tensor(ops["pad_ids"][k],
                                              device=dev).long()
            if "send_slots" in ops:
                sops["send_slots"] = torch.as_tensor(ops["send_slots"][k],
                                                     device=dev).long()
            sops["buckets"] = []
            for b, stk in zip(buckets, ops["buckets"]):
                ta = shard_batch(stk, k, dev)
                kc = (real_pmask(bucket_const(
                    _shard_tileset(b, stk, k, plan), ta, with_adj, P_loc,
                    dmax, dev), stk, k, dev) if spmm else {})
                sops["buckets"].append((ta, kc))
            if "softmax" in ops:
                stk = ops["softmax"]
                ta = shard_batch(stk, k, dev)
                sops["softmax"] = (ta, real_pmask(
                    softmax_const(_shard_tileset(_source_tileset(tiles), stk,
                                                 k, plan), ta, P_loc, dmax,
                                  dev), stk, k, dev))
            sops["real"] = _scan_edges(self.sp, sops["buckets"], "local_pid",
                                       self.graph.n_vertices)
            out.append(sops)
        return out

    # ------------------------------------------------------------------ run
    def __call__(self, inputs: Dict, params: Dict,
                 operands: Optional[List[Dict]] = None) -> List[Array]:
        if operands is None:
            if self._operands is None:
                self._operands = self.bind(self.tiles, self.reordering)
            operands = self._operands
        by_dev: Dict[torch.device, Tuple[Dict, Dict]] = {}
        shards = []
        for k in self.mesh.local_shards:
            dev = self.mesh.shard_device(k)
            if dev not in by_dev:
                by_dev[dev] = ({n: to_device(v, dev) for n, v in inputs.items()},
                               {n: to_device(v, dev) for n, v in params.items()})
            shards.append(by_dev[dev])
        return [o.to(self.device) for o in self._run(shards, operands)]

    def run_with(self, tiles, inputs: Dict, params: Dict,
                 reordering=None) -> List[Array]:
        """Execute a different same-signature tile set through this runner
        (no rebuild: operand shapes are identical by contract)."""
        return self(inputs, params, operands=self.bind(tiles, reordering))

    def _run(self, shards: List[Tuple[Dict, Dict]],
             ops: List[Dict]) -> List[Array]:
        """One pass over the local shards (``shards`` / ``ops`` by
        position in ``mesh.local_shards``)."""
        sp = self.sp
        V = self.graph.n_vertices
        K, P_loc, dmax = self.n_devices, self.plan.n_local_parts, self.dmax
        local = range(len(self.mesh.local_shards))
        devs = [self.mesh.shard_device(k) for k in self.mesh.local_shards]
        pad_valid = [(o["pad_ids"] < V)[..., None] for o in ops]
        safe_pad_ids = [o["pad_ids"].clamp(max=V - 1) for o in ops]
        # drains queued for the next exchange: (ids, restricted, per-shard
        # values); ``queued`` holds their ids until they land in vstore
        pending: List[Tuple[List[int], bool, List[List[Array]]]] = []
        queued: set = set()
        # one interpreter a shard, with its own flat store and shard-local
        # padded (P_loc, Dmax, F) stores of gather results and dst values
        its: List[_Interpreter] = []
        for k, ((inputs, params), o) in enumerate(zip(shards, ops)):
            if "order" in o:
                # replicated permutation of replicated inputs: no exchange
                inputs = dict(inputs)
                for name in {name for _, name in sp.vertex_inputs}:
                    inputs[name] = inputs[name][o["order"]]
            its.append(_Interpreter(
                sp, params,
                {nid: inputs[name] for nid, name in sp.vertex_inputs},
                {nid: inputs[name] for nid, name in sp.edge_inputs},
                V, devs[k], real=o["real"], pid="local_pid",
                pending=queued))

        def queue(vals: List[Dict[int, Array]]) -> None:
            """Queue one drain (the reference's ``publish`` call): interior
            boundaries ship only the compacted send buffer; a drain that
            holds an output ships the full padded layout."""
            ids = list(vals[0])
            if not ids:
                return
            restricted = (K > 1 and "send_slots" in ops[0]
                          and not (set(ids) & set(sp.outputs)))
            pending.append((ids, restricted,
                            [[v[i] for i in ids] for v in vals]))
            queued.update(ids)

        def exchange() -> None:
            """ONE all-gather of every queued drain (XLA's combiner in the
            reference): each shard's payloads are flattened into one
            buffer, gathered, and scattered into its flat (V, F) store."""
            if not pending:
                return
            bufs = [[torch.cat(vals[k], dim=-1) for _, _, vals in pending]
                    for k in local]
            payload = []
            for k in local:
                parts = []
                for (_, restricted, _), buf in zip(pending, bufs[k]):
                    if restricted:
                        parts.append(buf.reshape(P_loc * dmax, -1)[
                            ops[k]["send_slots"]].reshape(-1))
                    else:
                        parts.append(torch.where(pad_valid[k], buf, 0.0)
                                     .reshape(-1))
                payload.append(torch.cat(parts))
            gathered = self.mesh.all_gather(payload)
            for k in local:
                off = 0
                for (ids, restricted, vals), buf in zip(pending, bufs[k]):
                    width = buf.shape[-1]
                    rows = (ops[k]["send_slots"].shape[0] if restricted
                            else P_loc * dmax)
                    flat = gathered[k][:, off:off + rows * width].reshape(
                        K * rows, width)
                    off += rows * width
                    if restricted:
                        # own partitions' rows never ride the exchange:
                        # written locally, after the received ones
                        store = _slots_to_vertices(
                            V, (ops[k]["send_ids"], flat),
                            (ops[k]["pad_ids"].reshape(-1),
                             buf.reshape(P_loc * dmax, -1)))
                    else:
                        store = _slots_to_vertices(
                            V, (ops[k]["full_pad_ids"], flat))
                    col = 0
                    for nid, v in zip(ids, vals[k]):
                        its[k].vstore[nid] = store[:, col:col + v.shape[-1]]
                        col += v.shape[-1]
            pending.clear()
            queued.clear()

        def tile_work(k, phase) -> Dict[int, Array]:
            """Shard ``k``'s gather blocks of ``phase``; returns the drains
            a tile-side path reads (the rest stay in its pstore)."""
            drained: Dict[int, Array] = {}

            def drain(recv_id, val):
                if recv_id in self._publish:
                    drained[recv_id] = val

            its[k].gather_blocks(phase, ops[k]["buckets"], ops[k].get("softmax"),
                                 P_loc, dmax, self.layout, drain)
            return drained

        for phase in sp.phases:
            # ---- destination block on every shard's local partitions; the
            # drains a tile-side path reads wait for the next exchange
            if phase.dst.store_ids:
                vals = []
                for k in local:
                    denv = its[k].eval_vertex(safe_pad_ids[k], phase.dst.nodes,
                                              padded=True)
                    for nid in phase.dst.store_ids:
                        its[k].dstore[nid] = denv[nid]
                    vals.append({nid: denv[nid] for nid in phase.dst.store_ids
                                 if nid in self._publish})
                queue(vals)
            if not phase.has_tile_work:
                continue
            # everything drained since the last tile work leaves in ONE
            # exchange (the static census counts on it)
            exchange()
            queue([tile_work(k, phase) for k in local])
        exchange()

        outs = [its[0].vstore[o] for o in sp.outputs]
        if "rank" in ops[0]:
            outs = [o[ops[0]["rank"]] for o in outs]
        return outs


def run_sharded(compiled: C.CompiledGNN, graph: Graph, tiles,
                inputs: Dict, params: Dict,
                n_devices: Optional[int] = None, mode: str = "cost",
                kernel_dispatch: bool = True, reordering=None,
                devices: Optional[Sequence] = None,
                device: Optional[Union[str, torch.device]] = None,
                mesh: Optional[ShardMesh] = None) -> List[Array]:
    """Build a :class:`ShardedRunner` and run it once."""
    return ShardedRunner(compiled, graph, tiles, n_devices, mode=mode,
                         kernel_dispatch=kernel_dispatch,
                         reordering=reordering, devices=devices,
                         device=device, mesh=mesh)(inputs, params)
