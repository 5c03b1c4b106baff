"""Graph-native GNN IR (ZIPPER paper §6.1).

The IR is a set of DAG *segments*.  Each segment is labeled as a ``vertex``
or ``edge`` segment and contains ops that operate on the data of a *single*
vertex or edge (graph-semantic atomicity).  Communication between segments
happens exclusively through paired ``send``/``recv`` ops, which are the
defused forms of the whole-graph GOPs (scatter / gather):

    scatter (vertex -> edge):  sendOutEdge  ->  recvSrc
                               sendInEdge   ->  recvDst
    gather  (edge -> vertex):  sendDstSum/sendDstMax/...  ->  recvInEdge

Entry/exit indicator ops (``input`` / ``output``) mark the program boundary
(Table 1 of the paper).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Op vocabulary
# ---------------------------------------------------------------------------

#: element-wise ops (VU in hardware) — unary (bias_add carries a param in attrs)
ELW_UNARY = ("relu", "leaky_relu", "exp", "sigmoid", "tanh", "neg",
             "identity", "sqrt", "rsqrt", "bias_add")
#: element-wise ops — binary (support broadcasting (N,1)x(N,F))
ELW_BINARY = ("add", "sub", "mul", "div", "max2", "min2")
#: GEMM-class ops (MU in hardware)
GEMM_OPS = ("matmul", "gemv", "bmm_edge")
#: communication sends (GOP halves)
SEND_OPS = ("sendOutEdge", "sendInEdge", "sendDstSum", "sendDstMax", "sendDstMean")
#: communication recvs (GOP halves)
RECV_OPS = ("recvSrc", "recvDst", "recvInEdge")
#: entry/exit indicators
INDICATOR_OPS = ("input", "output", "param", "const")

COMPUTE_OPS = ELW_UNARY + ELW_BINARY + GEMM_OPS
ALL_OPS = COMPUTE_OPS + SEND_OPS + RECV_OPS + INDICATOR_OPS

#: send -> expected recv pairing
SEND_TO_RECV = {
    "sendOutEdge": "recvSrc",
    "sendInEdge": "recvDst",
    "sendDstSum": "recvInEdge",
    "sendDstMax": "recvInEdge",
    "sendDstMean": "recvInEdge",
}

#: gather sends carry a reduction kind
GATHER_REDUCE = {"sendDstSum": "sum", "sendDstMax": "max", "sendDstMean": "mean"}


def op_unit(op: str, strict: bool = False) -> str:
    """Which hardware unit executes this op (paper §7.1).

    ``strict=True`` raises on ops outside the IR vocabulary instead of
    silently bucketing them into CTRL (the verifier's ZA001 check uses the
    vocabulary directly; codegen paths can opt in here).
    """
    if op in GEMM_OPS:
        return "MU"
    if op in ELW_UNARY or op in ELW_BINARY:
        return "VU"
    if op in SEND_OPS or op in RECV_OPS:
        return "VU"  # GOPs are offloaded to the Vector Unit (paper §7.1)
    if strict and op not in ALL_OPS:
        raise ValueError(f"op {op!r} is not in the IR vocabulary")
    return "CTRL"


# ---------------------------------------------------------------------------
# IR node / segment / program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IRNode:
    """A single-item op in a segment DAG.

    ``inputs`` reference other node ids *within the same segment*, except for
    ``recv*`` nodes whose ``comm_id`` links them to the matching ``send``
    node in another segment.
    """

    id: int
    op: str
    inputs: List[int] = dataclasses.field(default_factory=list)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: feature dimension of this node's output (per vertex / edge)
    dim: int = 0
    #: cross-segment communication channel id (send/recv only)
    comm_id: Optional[int] = None
    #: GNN layer that emitted this op (stacked models; 0 for single-layer)
    layer: int = 0

    def is_send(self) -> bool:
        return self.op in SEND_OPS

    def is_recv(self) -> bool:
        return self.op in RECV_OPS

    def short(self) -> str:
        extra = f" comm={self.comm_id}" if self.comm_id is not None else ""
        args = ', '.join('%%%d' % i for i in self.inputs)
        return f"%{self.id} = {self.op}({args}) dim={self.dim}{extra}"


@dataclasses.dataclass
class Segment:
    """A DAG of IRNodes labeled with graph semantics."""

    kind: str  # "vertex" | "edge"
    index: int
    nodes: Dict[int, IRNode] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        tag = "v" if self.kind == "vertex" else "e"
        return f"IR.{tag}.{self.index}"

    def add(self, node: IRNode) -> IRNode:
        assert node.id not in self.nodes
        self.nodes[node.id] = node
        return node

    def toposort(self) -> List[IRNode]:
        """Topological order; recv nodes have no intra-segment deps."""
        indeg = {nid: 0 for nid in self.nodes}
        succs: Dict[int, List[int]] = {nid: [] for nid in self.nodes}
        for n in self.nodes.values():
            for i in n.inputs:
                if i in self.nodes:
                    indeg[n.id] += 1
                    succs[i].append(n.id)
        ready = collections.deque(sorted(nid for nid, d in indeg.items() if d == 0))
        order: List[IRNode] = []
        while ready:
            nid = ready.popleft()
            order.append(self.nodes[nid])
            for s in sorted(succs[nid]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            # name the offending nodes, with the same wording the analyzer's
            # ZA003 diagnostic uses (lazy import: analysis depends on ir)
            from .analysis.diagnostics import find_cycle, format_cycle
            raise ValueError(format_cycle(self.label, find_cycle(succs)))
        return order

    def sends(self) -> List[IRNode]:
        return [n for n in self.nodes.values() if n.is_send()]

    def recvs(self) -> List[IRNode]:
        return [n for n in self.nodes.values() if n.is_recv()]


@dataclasses.dataclass
class IRProgram:
    """A full graph-native IR program: multiple disconnected segments."""

    segments: List[Segment] = dataclasses.field(default_factory=list)
    #: comm_id -> (send_segment_idx, send_node_id, recv_segment_idx, recv_node_id)
    channels: Dict[int, Tuple[int, int, int, int]] = dataclasses.field(default_factory=dict)
    name: str = "gnn"
    _next_id: int = 0
    _next_comm: int = 0

    # -- construction helpers -------------------------------------------------
    def fresh_id(self) -> int:
        self._next_id += 1
        return self._next_id - 1

    def fresh_comm(self) -> int:
        self._next_comm += 1
        return self._next_comm - 1

    def new_segment(self, kind: str) -> Segment:
        seg = Segment(kind=kind, index=len([s for s in self.segments if s.kind == kind]))
        self.segments.append(seg)
        return seg

    def rebuild_channels(self) -> None:
        """Recompute the channel table from send/recv comm ids."""
        sends: Dict[int, Tuple[int, int]] = {}
        recvs: Dict[int, Tuple[int, int]] = {}
        for si, seg in enumerate(self.segments):
            for n in seg.nodes.values():
                if n.is_send():
                    sends[n.comm_id] = (si, n.id)
                elif n.is_recv():
                    recvs[n.comm_id] = (si, n.id)
        self.channels = {}
        for cid, (rsi, rnid) in recvs.items():
            if cid not in sends:
                # an orphaned recv would read from nowhere; dropping it
                # silently used to hide defused-GOP bugs
                raise ValueError(f"recv comm {cid} has no send")
        for cid, (ssi, snid) in sends.items():
            if cid not in recvs:
                raise ValueError(f"send comm {cid} has no recv")
            rsi, rnid = recvs[cid]
            self.channels[cid] = (ssi, snid, rsi, rnid)

    # -- queries ---------------------------------------------------------------
    def find_node(self, nid: int) -> Tuple[Segment, IRNode]:
        for seg in self.segments:
            if nid in seg.nodes:
                return seg, seg.nodes[nid]
        raise KeyError(nid)

    def op_count(self, ops: Optional[Iterable[str]] = None) -> int:
        ops = set(ops) if ops is not None else None
        return sum(
            1
            for seg in self.segments
            for n in seg.nodes.values()
            if ops is None or n.op in ops
        )

    def edge_segments(self) -> List[Segment]:
        return [s for s in self.segments if s.kind == "edge"]

    def vertex_segments(self) -> List[Segment]:
        return [s for s in self.segments if s.kind == "vertex"]

    def validate(self) -> None:
        """Structural invariants: paired channels, space-correct sends."""
        self.rebuild_channels()
        for cid, (ssi, snid, rsi, rnid) in self.channels.items():
            send = self.segments[ssi].nodes[snid]
            recv = self.segments[rsi].nodes[rnid]
            if SEND_TO_RECV[send.op] != recv.op:
                raise ValueError(f"channel {cid}: {send.op} paired with {recv.op}")
            # scatter: vertex->edge ; gather: edge->vertex
            if send.op in ("sendOutEdge", "sendInEdge"):
                if self.segments[ssi].kind != "vertex" or self.segments[rsi].kind != "edge":
                    raise ValueError(f"channel {cid}: scatter must go vertex->edge")
            else:
                if self.segments[ssi].kind != "edge" or self.segments[rsi].kind != "vertex":
                    raise ValueError(f"channel {cid}: gather must go edge->vertex")
            if send.dim != recv.dim:
                raise ValueError(f"channel {cid}: dim mismatch {send.dim} vs {recv.dim}")
        for seg in self.segments:
            seg.toposort()  # raises on cycles

    def pretty(self) -> str:
        lines = [f"IRProgram<{self.name}>"]
        for seg in self.segments:
            lines.append(f"  segment {seg.label}:")
            for n in seg.toposort():
                lines.append(f"    {n.short()}" + (f" attrs={n.attrs}" if n.attrs else ""))
        return "\n".join(lines)
