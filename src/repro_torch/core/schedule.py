"""Scheduled phase-program layer (paper §6–§7): one lowering, three engines.

ZIPPER's compiler lowers graph-native IR into a *schedule* that a run-time
scheduler maps onto dedicated hardware blocks.  This module is that layer:
:func:`lower` turns an :class:`~repro.core.compiler.SDEPlan` into an explicit
:class:`ScheduledProgram` — per gather level one :class:`Phase` of typed
blocks — and every engine (``executor.run_tiled``, ``pipeline.PipelinedRunner``,
``isa.emit_sde`` + the cycle simulator) *interprets* the same program instead
of re-deriving levels and roles on its own.

Blocks per phase:

* :class:`SrcBlock`  — source-replica vertex compute, evaluated per tile on
  the compacted source rows.
* :class:`EdgeBlock` — per-edge compute feeding the scan-path gathers
  (recvs + element-wise/BMM chains).
* :class:`GatherBlock` — one per gather channel, carrying its accumulator
  spec and a ``kernel`` tag chosen by the pattern-matching scheduler pass:

  - ``pallas_spmm``            for  recvSrc -> sendDstSum        (pure SpMM)
  - ``pallas_spmm_weighted``   for  recvSrc * α -> sendDstSum    (α: per-edge
    scalar computed on the edge segment)
  - ``pallas_segment_softmax`` for the GAT edge-softmax motif — the THREE
    gather levels (max, sum-of-exp, weighted sum) fuse into one online-softmax
    block (see :func:`_match_softmax_motifs`)
  - ``scan``                   fallback (BMM / max / mean phases, or when
    kernel dispatch is off)

* :class:`DstBlock`  — destination-replica vertex compute, evaluated per
  partition, publishing phase results into the global vertex store.

The lowering is graph-independent (pure compile-time); engines bind it to a
tile set at run time.

Multi-layer programs lower exactly the same way: one :class:`SDEPlan` spans
every stacked layer, each :class:`Phase` carries the ``layer`` whose tile
work it runs, and the stream scheduler / simulator use those tags to
software-pipeline across layer boundaries (``inter_layer="pipelined"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import ir as IR
from .compiler import SDEPlan

# kernel tags ---------------------------------------------------------------
KERNEL_SCAN = "scan"
KERNEL_SPMM = "pallas_spmm"
KERNEL_SPMM_WEIGHTED = "pallas_spmm_weighted"
KERNEL_SEGMENT_SOFTMAX = "pallas_segment_softmax"

PALLAS_KERNELS = (KERNEL_SPMM, KERNEL_SPMM_WEIGHTED, KERNEL_SEGMENT_SOFTMAX)


# ---------------------------------------------------------------------------
# typed blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AccumSpec:
    """Gather accumulator: which channel, which reduction, which result slot."""

    comm_id: int
    kind: str            # 'sum' | 'max' | 'mean'
    dim: int
    send_id: int         # edge-side sendDst* node
    value_id: int        # edge node feeding the send
    recv_id: int         # vertex-side recvInEdge node the result publishes to


@dataclasses.dataclass
class SrcBlock:
    """Source-replica vertex compute (per tile, on compacted source rows)."""

    role = "src"
    nodes: List[IR.IRNode]            # cumulative topo order up to this phase
    fresh: List[IR.IRNode]            # nodes whose own level == this phase


@dataclasses.dataclass
class DstBlock:
    """Destination-replica vertex compute (per partition)."""

    role = "dst"
    nodes: List[IR.IRNode]            # cumulative topo order (incl. outputs)
    fresh: List[IR.IRNode]
    store_ids: List[int]              # node ids published to the vertex store


@dataclasses.dataclass
class EdgeBlock:
    """Per-edge compute feeding the scan-path gathers of this phase."""

    role = "edge"
    nodes: List[IR.IRNode]            # topo order; recvs + compute, no sends
    fresh: List[IR.IRNode]            # all edge nodes of this level (ISA order)


@dataclasses.dataclass
class GatherBlock:
    """One gather channel of this phase, dispatched to a hardware block."""

    acc: AccumSpec
    kernel: str = KERNEL_SCAN
    #: vertex node whose value feeds the kernel's dense X operand
    src_value_id: Optional[int] = None
    #: edge node computing the per-edge scalar weight α (weighted SpMM)
    weight_id: Optional[int] = None
    #: edge node computing the per-edge score e (segment softmax)
    score_id: Optional[int] = None
    #: edge nodes (topo order) to evaluate for the kernel's edge operands
    edge_nodes: List[IR.IRNode] = dataclasses.field(default_factory=list)
    #: node ids subsumed by this block (fused motif internals, skip everywhere)
    covered: Set[int] = dataclasses.field(default_factory=set)
    #: gather levels folded into this block (softmax fusion spans three)
    fused_levels: Tuple[int, ...] = ()


@dataclasses.dataclass
class Phase:
    """All work between two gather barriers."""

    level: int
    src: SrcBlock
    edge: EdgeBlock
    gathers: List[GatherBlock]
    dst: DstBlock
    #: GNN layer whose tile work this phase carries (stacked models).  A
    #: boundary phase drains layer ``layer-1``'s gather in its dst block
    #: while running layer ``layer``'s src/edge/gather tile work.
    layer: int = 0

    @property
    def has_tile_work(self) -> bool:
        return bool(self.edge.nodes or self.gathers)

    def scan_gathers(self) -> List[GatherBlock]:
        return [g for g in self.gathers if g.kernel == KERNEL_SCAN]

    def kernel_gathers(self) -> List[GatherBlock]:
        return [g for g in self.gathers if g.kernel != KERNEL_SCAN]


@dataclasses.dataclass
class ScheduledProgram:
    """The explicit dataflow program every engine interprets."""

    plan: SDEPlan
    prog: IR.IRProgram
    phases: List[Phase]
    outputs: List[int]                     # output node ids, declaration order
    #: recvSrc/recvDst node id -> vertex node id whose value it carries
    scatter_value_of: Dict[int, int]
    #: (node id, input name) pairs for vertex- and edge-space inputs
    vertex_inputs: List[Tuple[int, str]]
    edge_inputs: List[Tuple[int, str]]
    kernel_dispatch: bool
    #: feature widths the data-transfer instructions move (ISA codegen)
    src_load_dim: int = 0
    dst_load_dim: int = 0
    edge_feat_dim: int = 0
    out_dim: int = 0
    #: GNN layers spanned by this program (stacked models; 1 otherwise)
    n_layers: int = 1

    @property
    def max_level(self) -> int:
        return self.phases[-1].level if self.phases else 0

    def layer_of_level(self) -> Dict[int, int]:
        """level -> GNN layer whose tile work runs at that level."""
        return {p.level: p.layer for p in self.phases}

    def kernels_by_level(self) -> Dict[int, List[str]]:
        return {p.level: [g.kernel for g in p.gathers] for p in self.phases
                if p.gathers}

    def gather_kernel(self, level: int) -> Optional[str]:
        """Kernel tag of the (first) gather block at ``level``, if any."""
        for p in self.phases:
            if p.level == level and p.gathers:
                return p.gathers[0].kernel
        return None

    def structure_signature(self) -> Tuple:
        """Cheap structural identity of the lowered program: phase/kernel-tag
        layout plus the feature widths every engine compilation depends on.
        Same signature => the same jitted runner can execute it (the serving
        program cache keys on this together with the tile-set signature).
        Memoized — safe to call on the per-request serving hot path."""
        cached = getattr(self, "_structure_sig", None)
        if cached is not None:
            return cached

        def block(nodes: Sequence[IR.IRNode]) -> Tuple:
            # every attr participates: trace-time constants (leaky_relu slope,
            # weight shapes, ...) bake into the compiled program, so programs
            # differing only there must not share a warm runner
            return tuple((n.op, n.dim,
                          tuple(sorted((k, repr(v))
                                       for k, v in n.attrs.items())))
                         for n in nodes)

        sig = ("sched", self.prog.name, self.kernel_dispatch, self.n_layers,
               tuple((p.level, p.layer, tuple(g.kernel for g in p.gathers),
                      block(p.src.fresh), block(p.edge.fresh),
                      block(p.dst.fresh))
                     for p in self.phases),
               self.src_load_dim, self.dst_load_dim, self.edge_feat_dim,
               self.out_dim)
        self._structure_sig = sig
        return sig

    def pretty(self) -> str:
        lines = [f"ScheduledProgram<{self.prog.name}> "
                 f"(kernel_dispatch={self.kernel_dispatch})"]
        for p in self.phases:
            lines.append(f"  phase {p.level}:")
            if p.src.fresh:
                lines.append(f"    src : {[n.op for n in p.src.fresh]}")
            if p.edge.nodes:
                lines.append(f"    edge: {[n.op for n in p.edge.nodes]}")
            for g in p.gathers:
                lines.append(f"    gather comm={g.acc.comm_id} kind={g.acc.kind}"
                             f" -> {g.kernel}")
            if p.dst.fresh:
                lines.append(f"    dst : {[n.op for n in p.dst.fresh]}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# softmax motif matching (GAT edge softmax, three fused gather levels)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SoftmaxMotif:
    level: int                 # level of the sendDstMax head
    score_id: int              # edge node computing the raw scores e
    src_value_id: int          # vertex node feeding the message recvSrc
    out_send: IR.IRNode        # final sendDstSum
    out_recv_id: int           # recvInEdge publishing the aggregated result
    covered: Set[int]          # every node subsumed by the fused block
    fused_levels: Tuple[int, int, int]


def _match_softmax_motifs(plan: SDEPlan, nodes: Dict[int, IR.IRNode],
                          send_of_comm: Dict[int, int],
                          recv_of_comm: Dict[int, int]) -> List[_SoftmaxMotif]:
    """Find the numerically-stable edge-softmax shape emitted by
    ``trace.GraphRef.edge_softmax`` followed by a weighted sum-gather:

        m  = gather_max(e)                       level L
        ex = exp(e - scatter_dst(m))             level L+1 edge
        s  = gather_sum(ex)                      level L+1
        α  = ex / scatter_dst(s)                 level L+2 edge
        out = gather_sum(recvSrc(h) * α)         level L+2

    All intermediates must be private to the motif (single-consumer chain),
    so fusing them into one online-softmax block is observationally
    equivalent.  Returns one motif per match.
    """
    consumers: Dict[int, List[IR.IRNode]] = {}
    for n in nodes.values():
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)

    def only_consumer(nid: int) -> Optional[IR.IRNode]:
        cons = consumers.get(nid, [])
        return cons[0] if len(cons) == 1 else None

    def recv_of_scatter(vertex_nid: int) -> Optional[IR.IRNode]:
        """vertex value -> its single scatter send -> the edge-side recv."""
        send = only_consumer(vertex_nid)
        if send is None or send.op not in ("sendInEdge", "sendOutEdge"):
            return None
        return nodes[recv_of_comm[send.comm_id]]

    motifs: List[_SoftmaxMotif] = []
    for smax in nodes.values():
        if smax.op != "sendDstMax":
            continue
        lvl = plan.level[smax.id]
        e0 = smax.inputs[0]
        m_recv_id = recv_of_comm[smax.comm_id]          # vertex recvInEdge m
        # m must only feed a scatter_dst back to the edge segment
        m_edge = recv_of_scatter(m_recv_id)
        if m_edge is None or m_edge.op != "recvDst":
            continue
        # shifted = sub(e0, m_edge); the score e0 feeds ONLY smax and sub
        sub = only_consumer(m_edge.id)
        if (sub is None or sub.op != "sub" or sub.inputs != [e0, m_edge.id]
                or {c.id for c in consumers.get(e0, [])} != {smax.id, sub.id}):
            continue
        ex = only_consumer(sub.id)
        if ex is None or ex.op != "exp":
            continue
        # ex feeds the sum-gather and the normalizing division — exactly
        ex_cons = consumers.get(ex.id, [])
        ssum = next((c for c in ex_cons if c.op == "sendDstSum"), None)
        div = next((c for c in ex_cons if c.op == "div"), None)
        if ssum is None or div is None or len(ex_cons) != 2:
            continue
        s_recv_id = recv_of_comm[ssum.comm_id]          # vertex recvInEdge s
        s_edge = recv_of_scatter(s_recv_id)
        if s_edge is None or s_edge.op != "recvDst":
            continue
        if div.inputs != [ex.id, s_edge.id] or only_consumer(s_edge.id) is not div:
            continue
        # msg = mul(recvSrc(h), α) in either operand order
        mul = only_consumer(div.id)
        if mul is None or mul.op != "mul":
            continue
        other = [i for i in mul.inputs if i != div.id]
        if len(other) != 1:
            continue
        rs = nodes[other[0]]
        if rs.op != "recvSrc" or only_consumer(rs.id) is not mul:
            continue
        out_send = only_consumer(mul.id)
        if out_send is None or out_send.op != "sendDstSum":
            continue
        # private vertex-side intermediates: m and s feed nothing else
        m_send = only_consumer(m_recv_id)
        s_send = only_consumer(s_recv_id)
        if m_send is None or s_send is None:
            continue
        src_value_id = nodes[send_of_comm[rs.comm_id]].inputs[0]
        covered = {smax.id, m_recv_id, m_send.id, m_edge.id, sub.id, ex.id,
                   ssum.id, s_recv_id, s_send.id, s_edge.id, div.id, rs.id,
                   mul.id, out_send.id,
                   send_of_comm[rs.comm_id]}
        motifs.append(_SoftmaxMotif(
            level=lvl, score_id=e0, src_value_id=src_value_id,
            out_send=out_send, out_recv_id=recv_of_comm[out_send.comm_id],
            covered=covered, fused_levels=(lvl, lvl + 1, lvl + 2)))
    return motifs


# ---------------------------------------------------------------------------
# per-gather kernel classification
# ---------------------------------------------------------------------------

def _classify_gather(send: IR.IRNode, nodes: Dict[int, IR.IRNode],
                     send_of_comm: Dict[int, int],
                     consumers: Dict[int, List[IR.IRNode]]) -> Tuple[str, Dict]:
    """Pattern-match one gather send onto a hardware block.

    The matched chain must be single-consumer so subsuming it into the
    kernel block leaves nothing dangling for the scan path.
    """
    def private(nid: int) -> bool:
        return len(consumers.get(nid, [])) == 1

    if send.op != "sendDstSum":
        return KERNEL_SCAN, {}
    val = nodes[send.inputs[0]]
    if val.op == "recvSrc" and private(val.id):
        # recvSrc -> sendDstSum: the pure-SpMM aggregation
        src_value = nodes[send_of_comm[val.comm_id]].inputs[0]
        return KERNEL_SPMM, {"src_value_id": src_value, "covered": {val.id}}
    if val.op == "mul" and private(val.id):
        # recvSrc * α -> sendDstSum: weighted SpMM with a runtime-densified
        # adjacency (α must be a per-edge scalar so it can live in A[t,d,s])
        a, b = (nodes[i] for i in val.inputs)
        for rs, w in ((a, b), (b, a)):
            if rs.op == "recvSrc" and w.dim == 1 and not w.is_recv() \
                    and private(rs.id):
                src_value = nodes[send_of_comm[rs.comm_id]].inputs[0]
                return KERNEL_SPMM_WEIGHTED, {
                    "src_value_id": src_value, "weight_id": w.id,
                    "covered": {val.id, rs.id}}
    return KERNEL_SCAN, {}


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def _edge_closure(targets: Sequence[int], nodes: Dict[int, IR.IRNode],
                  seg_of: Dict[int, IR.Segment]) -> Set[int]:
    """Transitive edge-segment dependencies of ``targets`` (incl. recvs)."""
    need: Set[int] = set()
    stack = list(targets)
    while stack:
        nid = stack.pop()
        if nid in need or seg_of[nid].kind != "edge":
            continue
        need.add(nid)
        n = nodes[nid]
        if not n.is_recv():          # recvs cross to the vertex side: stop
            stack.extend(n.inputs)
    return need


_GATHER_KIND = {"sendDstSum": "sum", "sendDstMax": "max", "sendDstMean": "mean"}


def lower(plan: SDEPlan, kernel_dispatch: bool = True) -> ScheduledProgram:
    """Lower an SDE plan into the explicit scheduled phase program.

    ``kernel_dispatch=False`` tags every gather ``scan`` and disables motif
    fusion — the pure multi-phase schedule of the paper.  The result is the
    single source of truth for levels, roles, and block membership: engines
    must not consult ``plan.level`` / ``plan.role`` themselves.
    """
    prog = plan.prog
    prog.rebuild_channels()
    send_of_comm = {cid: snid for cid, (_, snid, _, _) in prog.channels.items()}
    recv_of_comm = {cid: rnid for cid, (_, _, _, rnid) in prog.channels.items()}

    nodes: Dict[int, IR.IRNode] = {}
    seg_of: Dict[int, IR.Segment] = {}
    for seg in prog.segments:
        for n in seg.nodes.values():
            nodes[n.id] = n
            seg_of[n.id] = seg

    consumers: Dict[int, List[IR.IRNode]] = {}
    for n in nodes.values():
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)

    motifs = (_match_softmax_motifs(plan, nodes, send_of_comm, recv_of_comm)
              if kernel_dispatch else [])
    motif_at: Dict[int, List[_SoftmaxMotif]] = {}
    motif_covered: Set[int] = set()
    for m in motifs:
        motif_at.setdefault(m.level, []).append(m)
        motif_covered |= m.covered

    # vertex compute in deterministic (segment, topo) order
    vnodes: List[IR.IRNode] = [n for seg in prog.vertex_segments()
                               for n in seg.toposort()]
    enodes: List[IR.IRNode] = [n for seg in prog.edge_segments()
                               for n in seg.toposort()]

    def vcompute(n: IR.IRNode) -> bool:
        return n.op not in ("input",) and not n.is_send() and not n.is_recv()

    phases: List[Phase] = []
    cur_layer = 0   # phase layer tags are monotone across levels
    for lvl in range(plan.max_level + 1):
        # ---- source block ---------------------------------------------------
        src_nodes = [n for n in vnodes
                     if vcompute(n) and n.op != "output"
                     and "src" in plan.role[n.id] and plan.level[n.id] <= lvl]
        src_fresh = [n for n in src_nodes if plan.level[n.id] == lvl]

        # ---- destination block ----------------------------------------------
        dst_nodes = [n for n in vnodes
                     if vcompute(n) and plan.level[n.id] <= lvl
                     and ("dst" in plan.role[n.id] or n.op == "output")
                     and n.id not in motif_covered]
        dst_fresh = [n for n in dst_nodes if plan.level[n.id] == lvl]
        store_ids = [n.id for n in dst_fresh]

        # ---- gather blocks --------------------------------------------------
        gathers: List[GatherBlock] = []
        kernel_covered: Set[int] = set()        # edge nodes a kernel subsumes
        for m in motif_at.get(lvl, []):
            send = m.out_send
            acc = AccumSpec(comm_id=send.comm_id, kind="sum", dim=send.dim,
                            send_id=send.id, value_id=send.inputs[0],
                            recv_id=m.out_recv_id)
            score_need = _edge_closure([m.score_id], nodes, seg_of)
            # edge inputs are read lazily via the engines' estore lookup
            score_nodes = [n for n in enodes
                           if n.id in score_need and n.op != "input"]
            gathers.append(GatherBlock(
                acc=acc, kernel=KERNEL_SEGMENT_SOFTMAX,
                src_value_id=m.src_value_id, score_id=m.score_id,
                edge_nodes=score_nodes, covered=set(m.covered),
                fused_levels=m.fused_levels))
            kernel_covered |= m.covered

        lvl_sends = [n for n in enodes
                     if n.is_send() and n.op in _GATHER_KIND
                     and plan.level[n.id] == lvl and n.id not in motif_covered]
        for send in lvl_sends:
            acc = AccumSpec(comm_id=send.comm_id, kind=_GATHER_KIND[send.op],
                            dim=send.dim, send_id=send.id,
                            value_id=send.inputs[0],
                            recv_id=recv_of_comm[send.comm_id])
            kernel, extra = (_classify_gather(send, nodes, send_of_comm,
                                              consumers)
                             if kernel_dispatch else (KERNEL_SCAN, {}))
            g = GatherBlock(acc=acc, kernel=kernel,
                            src_value_id=extra.get("src_value_id"),
                            weight_id=extra.get("weight_id"))
            if kernel != KERNEL_SCAN:
                g.covered = set(extra.get("covered", set())) | {send.id}
                if g.weight_id is not None:
                    weight_need = _edge_closure([g.weight_id], nodes, seg_of)
                    g.edge_nodes = [n for n in enodes
                                    if n.id in weight_need and n.op != "input"]
                kernel_covered |= g.covered
            gathers.append(g)

        # ---- edge block: everything the scan path still needs ---------------
        scan_targets = [g.acc.value_id for g in gathers
                        if g.kernel == KERNEL_SCAN]
        scan_need = _edge_closure(scan_targets, nodes, seg_of)
        edge_nodes = [n for n in enodes
                      if n.id in scan_need and not n.is_send()
                      and n.op != "input"]
        edge_fresh = [n for n in enodes
                      if plan.level[n.id] == lvl and n.op != "input"
                      and n.id not in motif_covered
                      and n.id not in kernel_covered]

        cur_layer = max([cur_layer]
                        + [n.layer for n in src_fresh + dst_fresh + edge_fresh]
                        + [nodes[g.acc.send_id].layer for g in gathers])
        phases.append(Phase(
            level=lvl,
            src=SrcBlock(nodes=src_nodes, fresh=src_fresh),
            edge=EdgeBlock(nodes=edge_nodes, fresh=edge_fresh),
            gathers=gathers,
            dst=DstBlock(nodes=dst_nodes, fresh=dst_fresh, store_ids=store_ids),
            layer=cur_layer,
        ))

    scatter_value_of = {
        rnid: nodes[send_of_comm[cid]].inputs[0]
        for cid, rnid in recv_of_comm.items()
        if nodes[rnid].op in ("recvSrc", "recvDst")
    }
    outputs = sorted(n.id for n in nodes.values() if n.op == "output")
    vertex_inputs = [(n.id, n.attrs["name"]) for seg in prog.vertex_segments()
                     for n in seg.toposort() if n.op == "input"]
    edge_inputs = [(n.id, n.attrs["name"]) for seg in prog.edge_segments()
                   for n in seg.toposort() if n.op == "input"]

    src_load_dim = sum(nodes[nid].dim for nid, _ in vertex_inputs
                       if "src" in plan.role[nid])
    dst_load_dim = sum(nodes[nid].dim for nid, _ in vertex_inputs
                       if "dst" in plan.role[nid])
    edge_feat_dim = sum(nodes[nid].dim for nid, _ in edge_inputs)
    out_dim = sum(nodes[nid].dim for nid in outputs)

    return ScheduledProgram(
        plan=plan, prog=prog, phases=phases, outputs=outputs,
        scatter_value_of=scatter_value_of,
        vertex_inputs=vertex_inputs, edge_inputs=edge_inputs,
        kernel_dispatch=kernel_dispatch,
        src_load_dim=src_load_dim, dst_load_dim=dst_load_dim,
        edge_feat_dim=edge_feat_dim, out_dim=out_dim,
        n_layers=max((n.layer for n in nodes.values()), default=0) + 1)
