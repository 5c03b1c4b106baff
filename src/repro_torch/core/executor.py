"""GNN execution engines, in PyTorch (port of ``repro.core.executor``).

* :func:`apply_compute` — the 19 vertex/edge ops every engine shares.
* :func:`run_reference` — whole-graph oracle (the classic programming
  model, "DGL-functional" semantics): every op over the full vertex/edge
  tensors.  It is the correctness oracle and the non-tiled baseline.
* :func:`run_tiled` — ZIPPER's tiled execution as an interpreter over the
  compiled :class:`~repro_torch.core.schedule.ScheduledProgram`.  Source
  blocks run on the tiles' compacted source rows, edge blocks per tile,
  gather blocks accumulate into per-partition destination rows,
  destination blocks run per partition.  A gather block tagged with a
  kernel (``pallas_spmm`` / ``pallas_spmm_weighted`` /
  ``pallas_segment_softmax``) is one batched call of the port's tile
  kernel over the whole tile set (``kernels/tile_spmm/ops.py``: the CUDA
  kernel on CUDA tensors, its plain version on CPU tensors), on the same
  operands :class:`~repro_torch.core.pipeline.PipelinedRunner` binds.

All compute in float32.  The engines derive no levels or roles of their
own: block membership comes from ``schedule.lower``.  The production
engine is :mod:`.pipeline`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from ..convert import to_device
from ..device import resolve
from . import compiler as C
from . import schedule as S
from .tiling import TileSet
from ..gnn.graphs import Graph

Array = torch.Tensor

_NEG_INF = -1e30  # used instead of -inf so max-reduce stays NaN-free on empty segments


# ---------------------------------------------------------------------------
# shared op semantics
# ---------------------------------------------------------------------------

def _bmm_edge(x: Array, et: Array, w: Array) -> Array:
    """Per-edge type-selected product: out[e] = x[e] @ w[type[e]], one
    matmul per edge type (never materialises a weight per edge)."""
    types = et[..., 0].long()
    out = x.new_zeros(x.shape[:-1] + (w.shape[-1],))
    for k in range(w.shape[0]):
        sel = types == k
        out[sel] = x[sel] @ w[k]
    return out


def apply_compute(op: str, attrs: Dict, params: Dict[str, Array],
                  args: Sequence[Array]) -> Array:
    if op == "matmul" or op == "gemv":
        return args[0] @ params[attrs["weight"]]
    if op == "bias_add":
        return args[0] + params[attrs["weight"]]
    if op == "bmm_edge":
        return _bmm_edge(args[0], args[1], params[attrs["weight"]])
    if op == "add":
        return args[0] + args[1]
    if op == "sub":
        return args[0] - args[1]
    if op == "mul":
        return args[0] * args[1]
    if op == "div":
        return args[0] / args[1]
    if op == "max2":
        return torch.maximum(args[0], args[1])
    if op == "min2":
        return torch.minimum(args[0], args[1])
    if op == "relu":
        return torch.relu(args[0])
    if op == "leaky_relu":
        return torch.where(args[0] > 0, args[0], attrs.get("slope", 0.2) * args[0])
    if op == "exp":
        return torch.exp(args[0])
    if op == "sigmoid":
        return torch.sigmoid(args[0])
    if op == "tanh":
        return torch.tanh(args[0])
    if op == "neg":
        return -args[0]
    if op == "identity":
        return args[0]
    if op == "sqrt":
        return torch.sqrt(args[0])
    if op == "rsqrt":
        return torch.rsqrt(args[0])
    raise NotImplementedError(op)


# ---------------------------------------------------------------------------
# whole-graph reference (oracle / non-tiled baseline)
# ---------------------------------------------------------------------------

def run_reference(tr, graph: Graph, inputs: Dict, params: Dict,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> List[Array]:
    """Evaluate trace ``tr`` over the whole graph on ``device`` (``cuda``
    unless named).  ``inputs``/``params`` may be numpy or tensors."""
    dev = resolve(device)
    src = torch.as_tensor(graph.src, device=dev).long()
    dst = torch.as_tensor(graph.dst, device=dev).long()
    V = graph.n_vertices
    params = {k: to_device(v, dev) for k, v in params.items()}
    env: Dict[int, Array] = {}
    outs: List[Array] = []
    with torch.inference_mode():
        for n in tr.nodes:
            if n.op == "param":
                continue
            if n.op == "input":
                env[n.id] = to_device(inputs[n.attrs["name"]], dev)
            elif n.op == "output":
                outs.append(env[n.inputs[0]])
            elif n.op == "scatter_src":
                env[n.id] = env[n.inputs[0]][src]
            elif n.op == "scatter_dst":
                env[n.id] = env[n.inputs[0]][dst]
            elif n.op == "gather":
                e = env[n.inputs[0]]
                red = n.attrs["reduce"]
                if red == "sum":
                    env[n.id] = e.new_zeros((V, e.shape[1])).index_add_(0, dst, e)
                elif red == "max":
                    # empty segments -> -1e30, not -inf
                    env[n.id] = e.new_full((V, e.shape[1]), _NEG_INF).scatter_reduce_(
                        0, dst[:, None].expand_as(e), e, "amax", include_self=True)
                elif red == "mean":
                    s = e.new_zeros((V, e.shape[1])).index_add_(0, dst, e)
                    c = e.new_zeros((V, 1)).index_add_(0, dst, e.new_ones((e.shape[0], 1)))
                    env[n.id] = s / c.clamp_min(1.0)
                else:
                    raise ValueError(red)
            elif n.op in ("matmul", "gemv", "bias_add"):
                w = tr.node(n.inputs[1])
                env[n.id] = apply_compute(n.op, {"weight": w.attrs["name"]}, params,
                                          [env[n.inputs[0]]])
            elif n.op == "bmm_edge":
                w = tr.node(n.inputs[1])
                env[n.id] = apply_compute("bmm_edge", {"weight": w.attrs["name"]}, params,
                                          [env[n.inputs[0]], env[n.inputs[2]]])
            else:
                env[n.id] = apply_compute(n.op, n.attrs, params, [env[i] for i in n.inputs])
    return outs


# ---------------------------------------------------------------------------
# tiled ZIPPER execution: ScheduledProgram interpreter
# ---------------------------------------------------------------------------

class _TiledRun:
    def __init__(self, compiled: C.CompiledGNN, graph: Graph, tiles: TileSet,
                 inputs: Dict, params: Dict, kernel_dispatch: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        from .pipeline import _padded_partition_ids, _tile_arrays

        self.device = dev = resolve(device)
        self.sp: S.ScheduledProgram = compiled.schedule(kernel_dispatch)
        self.graph = graph
        self.tiles = tiles
        self.params = {k: to_device(v, dev) for k, v in params.items()}
        # global (V, dim) store: inputs, gather results, dst-computed values
        self.vstore: Dict[int, Array] = {
            nid: to_device(inputs[name], dev) for nid, name in self.sp.vertex_inputs}
        # global (E, dim) store for edge inputs
        self.estore: Dict[int, Array] = {
            nid: to_device(inputs[name], dev) for nid, name in self.sp.edge_inputs}
        # per-tile index arrays on the device; the tile loop slices them
        self.ta = _tile_arrays(tiles, dev)
        pad_ids, self.dmax = _padded_partition_ids(tiles)
        self._pad_ids = torch.as_tensor(pad_ids, device=dev).long().reshape(-1)
        self._kc: Dict[str, Dict[str, Array]] = {}   # kernel operands by tag

    # -- vertex-block evaluation ---------------------------------------------
    def _eval_vertex(self, nodes, rows: Array, store_ids=()) -> Dict[int, Array]:
        """Evaluate a Src/Dst block's node list on the given vertex rows
        (any shape).  ``store_ids`` writes those results back into the
        global vstore (destination replica).  Returns the local env."""
        env: Dict[int, Array] = {}

        def lookup(nid: int) -> Array:
            if nid in env:
                return env[nid]
            if nid in self.vstore:
                return self.vstore[nid][rows]
            raise KeyError(f"vertex value %{nid} unavailable")

        for n in nodes:
            if n.op == "output":
                env[n.id] = lookup(n.inputs[0])
            else:
                env[n.id] = apply_compute(n.op, n.attrs, self.params,
                                          [lookup(i) for i in n.inputs])
            if n.id in store_ids:
                if n.id not in self.vstore:
                    self.vstore[n.id] = env[n.id].new_zeros(
                        (self.graph.n_vertices, env[n.id].shape[-1]))
                self.vstore[n.id][rows] = env[n.id]
        return env

    # -- edge-block evaluation -----------------------------------------------
    def _eval_edge(self, nodes, senv: Dict[int, Array], src_rows: Array,
                   esrc: Array, edst_global: Array, egid: Array):
        """Evaluate an edge-block node list for one tile ((E,) edge
        coordinates, (S,) source rows) or for every tile at once ((T, E)
        and (T, S)).  Returns ``(eenv, elookup)``: the local env plus a
        lookup that falls back to the global edge-feature store."""
        eenv: Dict[int, Array] = {}

        def elookup(nid: int) -> Array:
            if nid in eenv:
                return eenv[nid]
            if nid in self.estore:
                return self.estore[nid][egid]
            raise KeyError(f"edge value %{nid} unavailable")

        for n in nodes:
            if n.op == "recvSrc":
                src_nid = self.sp.scatter_value_of[n.id]
                base = senv[src_nid] if src_nid in senv else self.vstore[src_nid][src_rows]
                idx = esrc[..., None].expand(*esrc.shape, base.shape[-1])
                eenv[n.id] = base.gather(-2, idx)          # base[.., esrc, :]
            elif n.op == "recvDst":
                src_nid = self.sp.scatter_value_of[n.id]
                eenv[n.id] = self.vstore[src_nid][edst_global]
            else:
                eenv[n.id] = apply_compute(n.op, n.attrs, self.params,
                                           [elookup(i) for i in n.inputs])
        return eenv, elookup

    # -- kernel-tagged gather blocks -----------------------------------------
    def _operands(self, kernel: str) -> Dict[str, Array]:
        """The kernel operands of the tile set (built at first use): the
        edge plan for the segment softmax and CSR SpMM, partition runs and,
        for pure COO SpMM, the dense adjacency."""
        from .pipeline import bucket_const, softmax_const

        if kernel not in self._kc:
            t, P = self.tiles, self.tiles.n_dst_parts
            if kernel == S.KERNEL_SEGMENT_SOFTMAX:
                self._kc[kernel] = softmax_const(t, P, self.dmax, self.device)
            else:
                self._kc[kernel] = bucket_const(t, self.ta, kernel == S.KERNEL_SPMM,
                                                P, self.dmax, self.device)
        return self._kc[kernel]

    def _run_kernel_gathers(self, phase: S.Phase) -> None:
        from .pipeline import kernel_gather

        t, ta, V = self.tiles, self.ta, self.graph.n_vertices
        P, dmax = t.n_dst_parts, self.dmax
        # every tile at once, padded slots included (they never contribute);
        # padded edge destinations clamp to V - 1 as the reference's do
        src_rows, esrc, egid = ta["src_ids"], ta["edge_src"], ta["edge_gid"]
        edst_global = (ta["part_start"][ta["part_id"]][:, None]
                       + ta["edge_dst"]).clamp(max=V - 1)
        for g in phase.kernel_gathers():
            senv = self._eval_vertex(phase.src.nodes, src_rows)   # (T, S, ...)
            h = (senv[g.src_value_id] if g.src_value_id in senv
                 else self.vstore[g.src_value_id][src_rows]).contiguous()
            vals = None
            if g.kernel != S.KERNEL_SPMM:
                _, elookup = self._eval_edge(g.edge_nodes, senv, src_rows, esrc,
                                             edst_global, egid)
                vid = (g.score_id if g.kernel == S.KERNEL_SEGMENT_SOFTMAX
                       else g.weight_id)
                vals = elookup(vid)[..., 0].contiguous()              # (T, E)
            out = kernel_gather(g.kernel, t.layout, self._operands(g.kernel),
                                ta, h, vals, P, dmax)
            # (P, Dmax, F) partition rows -> (V, F); invalid slots land on
            # the sentinel row V
            buf = out.new_zeros((V + 1, out.shape[-1]))
            buf[self._pad_ids] = out.reshape(P * dmax, -1)
            self.vstore[g.acc.recv_id] = buf[:V]

    # -- main loop -----------------------------------------------------------
    def run(self) -> List[Array]:
        t, ta, dev = self.tiles, self.ta, self.device
        V = self.graph.n_vertices
        for phase in self.sp.phases:
            # 1. destination/partition-scope block
            if phase.dst.store_ids:
                for p in range(t.n_dst_parts):
                    lo, n = int(t.part_start[p]), int(t.part_size[p])
                    if n == 0:
                        continue
                    rows = torch.arange(lo, lo + n, device=dev)
                    self._eval_vertex(phase.dst.nodes, rows,
                                      store_ids=set(phase.dst.store_ids))
            if not phase.has_tile_work:
                continue

            # 2. kernel-dispatched gather blocks (one batched call each)
            if phase.kernel_gathers():
                self._run_kernel_gathers(phase)

            # edge work that feeds no scan gather has no effect
            scan_gathers = phase.scan_gathers()
            if not scan_gathers:
                continue

            # 3. accumulators for the scan-path gathers
            acc_sum: Dict[int, Array] = {}
            acc_max: Dict[int, Array] = {}
            acc_cnt: Dict[int, Array] = {}
            for g in scan_gathers:
                cid, dim = g.acc.comm_id, g.acc.dim
                if g.acc.kind in ("sum", "mean"):
                    acc_sum[cid] = torch.zeros((V, dim), device=dev)
                    if g.acc.kind == "mean":
                        acc_cnt[cid] = torch.zeros((V, 1), device=dev)
                else:
                    acc_max[cid] = torch.full((V, dim), _NEG_INF, device=dev)

            # 4. tile loop over the real slots of each tile
            for ti in range(t.n_tiles):
                ns, ne = int(t.n_src[ti]), int(t.n_edge[ti])
                if ne == 0:
                    continue
                p = int(t.part_id[ti])
                src_rows = ta["src_ids"][ti, :ns]
                esrc = ta["edge_src"][ti, :ne]
                edst_global = ta["edge_dst"][ti, :ne] + int(t.part_start[p])
                egid = ta["edge_gid"][ti, :ne]

                senv = self._eval_vertex(phase.src.nodes, src_rows)
                _, elookup = self._eval_edge(phase.edge.nodes, senv, src_rows,
                                             esrc, edst_global, egid)
                for g in scan_gathers:
                    cid = g.acc.comm_id
                    val = elookup(g.acc.value_id)
                    if g.acc.kind in ("sum", "mean"):
                        acc_sum[cid].index_add_(0, edst_global, val)
                        if g.acc.kind == "mean":
                            acc_cnt[cid].index_add_(
                                0, edst_global, val.new_ones((ne, 1)))
                    else:
                        acc_max[cid].scatter_reduce_(
                            0, edst_global[:, None].expand_as(val), val,
                            "amax", include_self=True)

            # 5. publish scan-gather results for the next phase
            for g in scan_gathers:
                cid = g.acc.comm_id
                if g.acc.kind == "sum":
                    self.vstore[g.acc.recv_id] = acc_sum[cid]
                elif g.acc.kind == "mean":
                    self.vstore[g.acc.recv_id] = acc_sum[cid] / acc_cnt[cid].clamp_min(1.0)
                else:
                    self.vstore[g.acc.recv_id] = acc_max[cid]

        return [self.vstore[o] for o in self.sp.outputs]


def run_tiled(compiled: C.CompiledGNN, graph: Graph, tiles: TileSet,
              inputs: Dict, params: Dict, kernel_dispatch: bool = True,
              device: Optional[Union[str, torch.device]] = None) -> List[Array]:
    """Interpret the compiled scheduled program tile by tile on ``device``
    (``cuda`` unless named); returns the outputs as tensors there.

    ``kernel_dispatch=False`` forces every gather block onto the scan path
    (the paper's pure multi-phase schedule, no kernel blocks).
    ``inputs``/``params`` may be numpy or tensors.
    """
    run = _TiledRun(compiled, graph, tiles, inputs, params,
                    kernel_dispatch=kernel_dispatch, device=device)
    with torch.inference_mode():
        return run.run()
