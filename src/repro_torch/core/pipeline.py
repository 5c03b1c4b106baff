"""Tiled execution of a ScheduledProgram in PyTorch (port of
``repro.core.pipeline``: the single-device part, plus the numpy
:func:`shard_layout_signature` the autotuner records).

Like the reference engine, :class:`PipelinedRunner` is an *interpreter* of
the :class:`~repro_torch.core.schedule.ScheduledProgram` — it derives no
levels or roles of its own.  Per phase:

* the destination block runs vectorized over partitions,
* gather blocks tagged ``pallas_spmm`` / ``pallas_spmm_weighted`` launch the
  COO or CSR tile-SpMM kernel once per size bucket (partition outputs summed
  into a shared (P, Dmax, F) buffer),
* a gather block tagged ``pallas_segment_softmax`` launches the online
  segment-softmax kernel over the unbucketed tile batch (softmax state
  cannot be merged across buckets) — GAT's three softmax phases in ONE pass,
  on per-edge scores and the tiles' source replica, walking the batch's
  edge plan (built at bind, for either layout),
* ``scan``-tagged gathers (sage, rgcn) fold every tile's edges into the
  shared accumulators with one batched ``index_add_`` /
  ``scatter_reduce_`` per bucket: there is no kernel on that path.

The reference engine ``vmap``s and ``scan``s per tile; here the tile
dimension is written out, so every source, edge and kernel operand is a
(T, ...) tensor.  Execution is eager: a runner is built once per structure
signature and :meth:`PipelinedRunner.bind` / :meth:`~PipelinedRunner.run_with`
rebind another same-signature tile set without rebuilding.

``tiles`` may be a :class:`~repro_torch.core.tiling.TileSet` or a
:class:`~repro_torch.core.tiling.BucketedTileSet`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import compiler as C
from . import schedule as S
from ..convert import to_device
from ..device import resolve
from ..gnn.graphs import Graph
from ..kernels.tile_spmm import ops as tops
from ..kernels.tile_spmm.kernel import (check_partition_major, partition_ptr,
                                        tile_flags)
from ..kernels.tile_spmm.plan import coo_plan, csr_plan
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


def _tile_arrays(ts: TileSet, device: torch.device) -> Dict[str, Array]:
    """Per-tile index arrays as int64 tensors (indexing operands)."""
    return {k: torch.as_tensor(getattr(ts, k), device=device).long()
            for k in ("src_ids", "edge_src", "edge_dst", "edge_gid", "n_src",
                      "n_edge", "part_id", "part_start")}


def _perm_operand(reordering, device) -> Optional[Dict[str, Array]]:
    """(order, rank) tensors; ``None`` for the identity."""
    if reordering is None or reordering.is_identity:
        return None
    return {k: torch.as_tensor(getattr(reordering, k), device=device).long()
            for k in ("order", "rank")}


def _check_reorder_mode(expected: str, reordering) -> None:
    mode = "identity" if reordering is None else reordering.mode
    if mode != expected:
        raise ValueError(
            f"reordering mode {mode!r} does not match this runner's "
            f"compiled mode {expected!r}")


# ---- kernel operands and dispatch of a tile batch ---------------------------
# Both tiled engines call these: PipelinedRunner once per bind (per bucket),
# executor.run_tiled once per run (the whole tile set).

def tile_const(ts: TileSet, n_parts: int, device) -> Dict[str, Array]:
    """Kernel metadata for one tile batch: int32 partition ids, their
    runs ``part_ptr`` and FIRST/LAST flags, the partition presence
    mask, and for CSR tiles the int32 row pointers and column indices.
    ``part_ptr`` comes from the host array, so no launch syncs on it."""
    check_partition_major(ts.part_id)
    kc = dict(
        part_id=torch.as_tensor(ts.part_id, dtype=torch.int32, device=device),
        part_ptr=torch.as_tensor(partition_ptr(ts.part_id, n_parts),
                                 device=device),
        flags=torch.as_tensor(tile_flags(ts.part_id), device=device),
        pmask=torch.as_tensor(np.isin(np.arange(n_parts), ts.part_id),
                              device=device))
    if ts.layout == "csr":
        kc["row_ptr"] = torch.as_tensor(ts.row_ptr, dtype=torch.int32,
                                        device=device)
        kc["col"] = torch.as_tensor(ts.edge_src, dtype=torch.int32,
                                    device=device)
    return kc


def softmax_const(ts: TileSet, n_parts: int, dmax: int,
                  device) -> Dict[str, Array]:
    """Kernel metadata for the segment-softmax batch: the tile constants,
    the int32 edge lists and the batch's edge plan (built on the device,
    with the plan's host syncs)."""
    kc = tile_const(ts, n_parts, device)
    kc["col"] = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=device)
    if ts.layout == "csr":
        kc["plan"] = csr_plan(kc["row_ptr"], kc["part_id"], n_parts,
                              ts.edge_src.shape[1])
    else:
        kc["edge_dst"] = torch.as_tensor(ts.edge_dst, dtype=torch.int32,
                                         device=device)
        kc["n_edge"] = torch.as_tensor(ts.n_edge, dtype=torch.int32,
                                       device=device)
        kc["plan"] = coo_plan(kc["edge_dst"], kc["n_edge"], kc["part_id"],
                              n_parts, dmax)
    return kc


def bucket_const(b: TileSet, ta: Dict[str, Array], with_adj: bool,
                 n_parts: int, dmax: int, device) -> Dict[str, Array]:
    """Per-bucket kernel metadata for the SpMM blocks: over CSR tiles the
    CSR plan (built on the device), over COO tiles for pure SpMM the dense
    adjacency (built on the device from the edge arrays ``ta``)."""
    kc = tile_const(b, n_parts, device)
    if b.layout == "csr":
        kc["plan"] = csr_plan(kc["row_ptr"], kc["part_id"], n_parts,
                              b.edge_src.shape[1])
    elif with_adj:
        ones = torch.ones(ta["edge_src"].shape, device=device)
        kc["adj"] = tops.densify_edge_weights(
            ones, ta["edge_dst"], ta["edge_src"], ta["n_edge"],
            dmax=dmax, smax=b.s_max)
    return kc


def kernel_gather(kernel: str, layout: str, kc: Dict[str, Array],
                  ta: Dict[str, Array], h: Array, vals: Optional[Array],
                  n_parts: int, dmax: int) -> Array:
    """One kernel-tagged gather block over a tile batch: the source replica
    ``h`` (T, S, F), per-edge ``vals`` (T, E) — scores for the segment
    softmax, weights for weighted SpMM, ``None`` for pure SpMM — and the
    batch's operands ``kc`` (:func:`softmax_const` / :func:`bucket_const`)
    and int64 tile arrays ``ta``.  Returns (P, Dmax, F); partitions without
    a tile in the batch are zero."""
    if kernel == S.KERNEL_SEGMENT_SOFTMAX:
        # the kernel walks the edge plan and gathers h[t, edge_src] itself:
        # no dense score block, no (T, E, F) value block; a partition
        # without a tile has only zero rows in the plan
        if layout == "csr":
            return tops.gat_aggregate_csr(kc["row_ptr"], kc["col"], vals, h,
                                          kc["part_id"], kc["flags"],
                                          n_parts=n_parts, plan=kc["plan"])
        return tops.gat_aggregate(kc["edge_dst"], kc["n_edge"], kc["col"], vals,
                                  h, kc["part_id"], kc["flags"], n_parts=n_parts,
                                  dmax=dmax, plan=kc["plan"])
    if vals is not None:                       # padded edge slots weigh 0
        emask = (torch.arange(vals.shape[1], device=vals.device)[None, :]
                 < ta["n_edge"][:, None])
        vals = torch.where(emask, vals, 0.0)
    if layout == "csr":
        w = torch.ones(ta["edge_src"].shape, device=h.device) if vals is None else vals
        return tops.spmm_csr(kc["row_ptr"], kc["col"], w, h, kc["part_id"],
                             kc["flags"], n_parts=n_parts, plan=kc["plan"])
    adj = kc["adj"] if vals is None else tops.densify_edge_weights(
        vals, ta["edge_dst"], ta["edge_src"], ta["n_edge"], dmax=dmax,
        smax=h.shape[-2])
    out = tops.spmm(adj, h, kc["part_id"], kc["flags"], n_parts=n_parts,
                    part_ptr=kc["part_ptr"])
    # partitions with no tile in the batch: the COO kernel (like the
    # reference's) leaves them unwritten
    return torch.where(kc["pmask"][:, None, None], out, 0.0)


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


def _gather_accumulate(acc: Dict[str, Array], g, val: Array, emask: Array,
                       dest: Array) -> None:
    """Fold the real edges' values ``val[emask]`` of every tile into the
    accumulator rows ``dest`` (in place), one batched scatter."""
    cid = g.acc.comm_id
    v = val[emask]
    if g.acc.kind in ("sum", "mean"):
        acc[f"sum{cid}"].index_add_(0, dest, v)
        if g.acc.kind == "mean":
            acc[f"cnt{cid}"].index_add_(0, dest, v.new_ones((v.shape[0], 1)))
    else:
        acc[f"max{cid}"].scatter_reduce_(0, dest[:, None].expand_as(v), v,
                                         "amax", include_self=True)


def _drain_gather_acc(acc: Dict[str, Array], g, P: int, dmax: int) -> Array:
    cid = g.acc.comm_id
    if g.acc.kind == "sum":
        out = acc[f"sum{cid}"]
    elif g.acc.kind == "mean":
        out = acc[f"sum{cid}"] / acc[f"cnt{cid}"].clamp_min(1.0)
    else:
        out = acc[f"max{cid}"]
    return out.view(P, dmax, -1)


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
        self._pad_ids = torch.as_tensor(part_ids_pad, device=self.device).long()
        self._pad_valid = (self._pad_ids < V)[..., None]      # (P, Dmax, 1)
        self._safe_pad_ids = self._pad_ids.clamp(max=V - 1)
        self._kernels = {g.kernel for ph in self.sp.phases for g in ph.gathers}
        self._signature = (self.sp.structure_signature(),
                           tiles.shape_signature(), self.reorder_mode)
        self._operands: Optional[Tuple] = None   # lazy bind of ctor tiles

    @property
    def signature(self) -> Tuple:
        """(program, tile-set) structural identity this runner serves."""
        return self._signature

    def jit_cache_size(self) -> int:
        """Number of builds behind this runner: always 1, since execution
        is eager and a rebind never rebuilds (the reference runner counts
        its XLA compilations here)."""
        return 1

    # ------------------------------------------------------------------ bind
    def bind(self, tiles, reordering=None) -> Tuple:
        """Device operands (tile arrays + kernel constants + permutation) for
        a tile set structurally identical to the construction one — the
        per-request rebind step the serving cache runs instead of a
        rebuild.  ``reordering`` must realize the runner's reorder mode."""
        if tiles.shape_signature() != self.tiles.shape_signature():
            raise ValueError(
                "tile set is not structurally identical to this runner's: "
                f"{tiles.shape_signature()} != {self.tiles.shape_signature()}")
        _check_reorder_mode(self.reorder_mode, reordering)
        buckets: List[TileSet] = (
            list(tiles.buckets) if isinstance(tiles, BucketedTileSet) else [tiles])
        tas = tuple(_tile_arrays(b, self.device) for b in buckets)
        if self._kernels & {S.KERNEL_SPMM, S.KERNEL_SPMM_WEIGHTED}:
            P, with_adj = self.tiles.n_dst_parts, S.KERNEL_SPMM in self._kernels
            kcs = tuple(bucket_const(b, ta, with_adj, P, self.dmax, self.device)
                        for b, ta in zip(buckets, tas))
        else:
            kcs = tuple({} for _ in buckets)
        # the online-softmax state cannot be merged across buckets, so the
        # segment-softmax block always runs over the unbucketed tile batch
        ta0 = kc0 = None
        if S.KERNEL_SEGMENT_SOFTMAX in self._kernels:
            st = tiles.source if isinstance(tiles, BucketedTileSet) else tiles
            ta0 = _tile_arrays(st, self.device)
            kc0 = softmax_const(st, self.tiles.n_dst_parts, self.dmax,
                                self.device)
        return (tas, kcs, ta0, kc0, _perm_operand(reordering, self.device))

    # ------------------------------------------------------------------ run
    def __call__(self, inputs: Dict, params: Dict,
                 operands: Optional[Tuple] = None) -> List[Array]:
        if operands is None:
            if self._operands is None:
                self._operands = self.bind(self.tiles, self.reordering)
            operands = self._operands
        inputs = {k: to_device(v, self.device) for k, v in inputs.items()}
        params = {k: to_device(v, self.device) for k, v in params.items()}
        with torch.inference_mode():
            return self._run(inputs, params, *operands)

    def run_with(self, tiles, inputs: Dict, params: Dict,
                 reordering=None) -> List[Array]:
        """Execute a different same-signature tile set through this runner
        (no rebuild: operand shapes are identical by contract)."""
        return self(inputs, params, operands=self.bind(tiles, reordering))

    def _run(self, inputs, params, tas, kcs, ta0, kc0, perm) -> List[Array]:
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
        # it in ``pstore`` skips the unpad-scatter + re-gather round trip.
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
        pstore: Dict[int, Array] = {}

        def publish_gather(recv_id, padded_val):
            pstore[recv_id] = padded_val
            if recv_id in tile_side_reads:
                vstore[recv_id] = unpad(padded_val)

        def eval_vertex(rows, nodes, padded=False):
            """rows: vertex ids of any shape — (T, S) source slots or
            (P, Dmax) partition rows; ``padded=True`` (dst blocks) reads
            gather results still sitting in partition layout."""
            env: Dict[int, Array] = {}

            def lookup(nid):
                if nid in env:
                    return env[nid]
                if padded and nid in pstore:
                    return pstore[nid]
                return vstore[nid][rows]

            for n in nodes:
                if n.id not in env and n.id in vstore:
                    # value already drained by an earlier dst block (layer
                    # boundary): the source replica reads the stored rows
                    # instead of recomputing the previous layer per tile
                    continue
                if n.op == "output":
                    env[n.id] = lookup(n.inputs[0])
                else:
                    env[n.id] = apply_compute(n.op, n.attrs, params,
                                              [lookup(i) for i in n.inputs])
            return env

        def edge_env(nodes, xs, senv):
            """Edge-block evaluation over every tile of ``xs`` at once."""
            eenv: Dict[int, Array] = {}

            def elookup(nid):
                return eenv[nid] if nid in eenv else estore[nid][xs["edge_gid"]]

            for n in nodes:
                if n.op == "recvSrc":
                    src_nid = sp.scatter_value_of[n.id]
                    base = src_value(senv, src_nid, xs["src_ids"])   # (T, S, F)
                    eenv[n.id] = base[xs["tile"], xs["edge_src"]]
                elif n.op == "recvDst":
                    src_nid = sp.scatter_value_of[n.id]
                    eenv[n.id] = vstore[src_nid][xs["dst_global"]]
                else:
                    eenv[n.id] = apply_compute(n.op, n.attrs, params,
                                               [elookup(i) for i in n.inputs])
            return eenv, elookup

        def with_dst(ta):
            """Tile operands plus the global destination row of every edge
            slot and a (T, 1) tile index for batched gathers."""
            xs = dict(ta)
            xs["dst_global"] = (ta["part_start"][ta["part_id"]][:, None]
                                + ta["edge_dst"]).clamp(max=V - 1)
            xs["tile"] = torch.arange(ta["part_id"].shape[0], device=dev)[:, None]
            return xs

        def src_value(senv, nid, rows):
            return senv[nid] if nid in senv else vstore[nid][rows]

        def edge_values(g, vid, xs, senv):
            """(T, E) per-edge values ``vid`` of a kernel gather."""
            _, elookup = edge_env(g.edge_nodes, xs, senv)
            return elookup(vid)[..., 0].contiguous()

        def unpad(val):
            """(P, Dmax, d) partition-padded -> (V, d) vertex store."""
            flat = torch.where(self._pad_valid, val, 0.0).reshape(P * dmax, -1)
            buf = flat.new_zeros((V + 1, flat.shape[-1]))
            buf[self._pad_ids.reshape(-1)] = flat  # invalid rows -> sentinel V
            return buf[:V]

        for phase in sp.phases:
            # ---- destination block (vectorized over partitions; gather
            # results of the previous phase are consumed directly in padded
            # layout — the drain of layer l fuses into layer l+1's dst work)
            if phase.dst.store_ids:
                denv = eval_vertex(self._safe_pad_ids, phase.dst.nodes,
                                   padded=True)
                for nid in phase.dst.store_ids:
                    vstore[nid] = unpad(denv[nid])
            if not phase.has_tile_work:
                continue

            # ---- kernel-dispatched gather blocks
            for g in phase.kernel_gathers():
                if g.kernel == S.KERNEL_SEGMENT_SOFTMAX:
                    # per-edge scores and the source replica h (T, S, F) of
                    # the unbucketed batch
                    xs0 = with_dst(ta0)
                    senv = eval_vertex(xs0["src_ids"], phase.src.nodes)
                    h = src_value(senv, g.src_value_id, xs0["src_ids"]).contiguous()
                    scores = edge_values(g, g.score_id, xs0, senv)
                    publish_gather(g.acc.recv_id, kernel_gather(
                        g.kernel, self.layout, kc0, ta0, h, scores, P, dmax))
                    continue

                # SpMM variants: one kernel call per size bucket, partition
                # outputs summed into a shared (P, Dmax, F) buffer
                total = torch.zeros((P, dmax, g.acc.dim), device=dev)
                for ta, kc in zip(tas, kcs):
                    senv = eval_vertex(ta["src_ids"], phase.src.nodes)
                    xsrc = src_value(senv, g.src_value_id,
                                     ta["src_ids"]).contiguous()
                    w = (None if g.kernel == S.KERNEL_SPMM
                         else edge_values(g, g.weight_id, with_dst(ta), senv))
                    total += kernel_gather(g.kernel, self.layout, kc, ta, xsrc,
                                           w, P, dmax)
                publish_gather(g.acc.recv_id, total)

            # ---- scan-tagged gathers: one batched scatter per bucket into
            # accumulators shared across buckets
            scan_gathers = phase.scan_gathers()
            if scan_gathers:
                acc = _init_gather_acc(scan_gathers, P * dmax, dev)
                for ta in tas:
                    xs = with_dst(ta)
                    emask = (torch.arange(ta["edge_src"].shape[1], device=dev)[None, :]
                             < ta["n_edge"][:, None])
                    senv = eval_vertex(xs["src_ids"], phase.src.nodes)
                    _, elookup = edge_env(phase.edge.nodes, xs, senv)
                    dest = (ta["part_id"][:, None] * dmax + ta["edge_dst"])[emask]
                    for g in scan_gathers:
                        _gather_accumulate(acc, g, elookup(g.acc.value_id),
                                           emask, dest)
                for g in scan_gathers:
                    publish_gather(g.acc.recv_id,
                                   _drain_gather_acc(acc, g, P, dmax))

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
# the sharded layout's shape identity (numpy); the autotuner records it.
# ShardedRunner itself is not ported yet (ROADMAP A.7).
# ---------------------------------------------------------------------------

def _quantize_cap(n: int) -> int:
    """Round a per-shard tile capacity up to the next power of two (serving:
    small per-request variance in shard tile counts must map onto one
    compiled shape)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


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


def _shard_real_counts(ts: TileSet, plan: ShardPlan) -> List[int]:
    shard = plan.shard_of_part[ts.part_id]
    real = ts.n_edge > 0
    return [int(np.sum(real & (shard == k))) for k in range(plan.n_shards)]


def _exchange_cap(tiles, plan: ShardPlan, quantize_tile_cap: bool) -> int:
    """Static send-buffer capacity of the restricted boundary exchange:
    the largest per-shard send set (rows a shard owns that remote shards'
    gather blocks read), power-of-two quantized under serving's cap
    quantization so small per-request variance shares one compiled shape."""
    cap = max(1, exchange_sets(tiles, plan).max_send)
    return _quantize_cap(cap) if quantize_tile_cap else cap


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
    caps = []
    for counts in _shard_tile_counts(tiles, plan):
        cap = max(1, max(counts))
        caps.append(_quantize_cap(cap) if quantize_tile_cap else cap)
    if kernel_dispatch and S.KERNEL_SEGMENT_SOFTMAX in kernels:
        cap0 = max(1, max(_shard_real_counts(_source_tileset(tiles), plan)))
        caps.append(_quantize_cap(cap0) if quantize_tile_cap else cap0)
    if n_devices > 1:
        caps.append(_exchange_cap(tiles, plan, quantize_tile_cap))
    return ("shardlayout", n_devices, mode, int(model_axis),
            plan.n_local_parts, tuple(caps), bool(kernel_dispatch))
