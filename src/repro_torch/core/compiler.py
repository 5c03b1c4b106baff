"""ZIPPER compiler (paper §6): classic whole-graph trace -> graph-native IR
-> tile-level SDE (source / destination / edge) program.

Step 1  construct_ir   : defuse GOPs into send/recv pairs, split the trace
                         into maximal connected vertex/edge segments.
Step 2  (passes.py)    : IR-level optimization — E2V, DCE.
Step 3  plan_sde       : classify vertex ops into source / destination
                         replicas, derive gather-barrier *phases*, and emit
                         the SDE structure the executor / ISA codegen use.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from . import ir as IR
from . import trace as TR


# ---------------------------------------------------------------------------
# Step 1: trace -> IRProgram
# ---------------------------------------------------------------------------

class _UF:
    def __init__(self):
        self.p: Dict[object, object] = {}

    def find(self, x):
        self.p.setdefault(x, x)
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


_GOP_SEND = {
    "scatter_src": "sendOutEdge",
    "scatter_dst": "sendInEdge",
}
_GATHER_SEND = {"sum": "sendDstSum", "max": "sendDstMax", "mean": "sendDstMean"}


def construct_ir(tr: TR.GnnTrace) -> IR.IRProgram:
    """Paper §6.1 step 1: build the graph-native IR from a whole-graph trace."""
    prog = IR.IRProgram(name=tr.name)
    is_gop = lambda n: n.op in TR.GOP_TRACE_OPS
    is_param = lambda n: n.op == "param"

    # --- component discovery ------------------------------------------------
    # tokens: ('n', id) for non-GOP non-param nodes; ('r', id) for each GOP's recv side
    uf = _UF()
    for n in tr.nodes:
        if is_gop(n) or is_param(n):
            continue
        tok = ("n", n.id)
        uf.find(tok)
        for i in n.inputs:
            m = tr.node(i)
            if is_param(m):
                continue
            if is_gop(m):
                uf.union(tok, ("r", m.id))
            else:
                uf.union(tok, ("n", m.id))
    # GOP chained directly into GOP: the downstream GOP's send lives in the
    # upstream GOP's recv component (create the token so the segment exists).
    for n in tr.nodes:
        if not is_gop(n):
            continue
        uf.find(("r", n.id))

    # component -> segment
    comp_space: Dict[object, str] = {}

    def _space_of_token(tok) -> str:
        kind, nid = tok
        return tr.node(nid).space  # GOP node's output space == recv side space

    comps: Dict[object, List[object]] = {}
    for n in tr.nodes:
        if is_param(n):
            continue
        tok = ("r", n.id) if is_gop(n) else ("n", n.id)
        comps.setdefault(uf.find(tok), []).append(tok)

    seg_of_comp: Dict[object, IR.Segment] = {}
    for root, toks in sorted(comps.items(), key=lambda kv: min(t[1] for t in kv[1])):
        spaces = {_space_of_token(t) for t in toks}
        if len(spaces) != 1:
            raise ValueError(f"mixed-space component {spaces}: GOP defusion failed")
        kind = "vertex" if spaces == {"V"} else "edge"
        seg_of_comp[root] = prog.new_segment(kind)

    def seg_of(tok) -> IR.Segment:
        return seg_of_comp[uf.find(tok)]

    # --- node materialization -------------------------------------------------
    irid_of: Dict[Tuple[str, int], int] = {}  # ('n'|'r', trace id) -> IR node id

    def _mapped_input(i: int) -> int:
        m = tr.node(i)
        key = ("r", m.id) if is_gop(m) else ("n", m.id)
        return irid_of[key]

    for n in tr.nodes:  # trace order is topological
        if is_param(n):
            continue
        lay = tr.layer_of.get(n.id, 0)
        if is_gop(n):
            src_trace = tr.node(n.inputs[0])
            # send lives in the producer's component
            prod_tok = ("r", src_trace.id) if is_gop(src_trace) else ("n", src_trace.id)
            send_seg = seg_of(prod_tok)
            recv_seg = seg_of(("r", n.id))
            cid = prog.fresh_comm()
            if n.op == "gather":
                send_op = _GATHER_SEND[n.attrs["reduce"]]
                recv_op = "recvInEdge"
            else:
                send_op = _GOP_SEND[n.op]
                recv_op = IR.SEND_TO_RECV[send_op]
            send = IR.IRNode(
                id=prog.fresh_id(), op=send_op, inputs=[_mapped_input(n.inputs[0])],
                dim=n.dim, comm_id=cid, layer=lay,
                attrs={"reduce": n.attrs.get("reduce")} if n.op == "gather" else {},
            )
            send_seg.add(send)
            recv = IR.IRNode(id=prog.fresh_id(), op=recv_op, inputs=[], dim=n.dim,
                             comm_id=cid, layer=lay)
            recv_seg.add(recv)
            irid_of[("r", n.id)] = recv.id
            continue
        seg = seg_of(("n", n.id))
        if n.op == "input":
            node = IR.IRNode(id=prog.fresh_id(), op="input", inputs=[], dim=n.dim,
                             layer=lay, attrs={"name": n.attrs["name"]})
        elif n.op == "output":
            node = IR.IRNode(id=prog.fresh_id(), op="output", layer=lay,
                             inputs=[_mapped_input(n.inputs[0])], dim=n.dim)
        elif n.op in ("matmul", "gemv", "bias_add"):
            w = tr.node(n.inputs[1])
            node = IR.IRNode(id=prog.fresh_id(), op=n.op, layer=lay,
                             inputs=[_mapped_input(n.inputs[0])], dim=n.dim,
                             attrs={"weight": w.attrs["name"], "wshape": w.attrs["shape"]})
        elif n.op == "bmm_edge":
            w = tr.node(n.inputs[1])
            node = IR.IRNode(id=prog.fresh_id(), op="bmm_edge", layer=lay,
                             inputs=[_mapped_input(n.inputs[0]), _mapped_input(n.inputs[2])],
                             dim=n.dim,
                             attrs={"weight": w.attrs["name"], "wshape": w.attrs["shape"]})
        else:  # element-wise
            node = IR.IRNode(id=prog.fresh_id(), op=n.op, layer=lay,
                             inputs=[_mapped_input(i) for i in n.inputs], dim=n.dim,
                             attrs=dict(n.attrs))
        seg.add(node)
        irid_of[("n", n.id)] = node.id

    prog.validate()
    return prog


# ---------------------------------------------------------------------------
# Step 3: SDE planning — roles, phases
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SDEPlan:
    """Tile-level execution plan derived from an optimized IRProgram.

    ``level[nid]``     — number of gather barriers the node's value depends on.
    ``role[nid]``      — subset of {"src","dst"} for vertex nodes (paper: the
                         source / destination replicas of a vertex segment).
    ``max_level``      — number of tile-loop phases = max_level + 1.
    """

    prog: IR.IRProgram
    level: Dict[int, int]
    role: Dict[int, Set[str]]
    max_level: int


def plan_sde(prog: IR.IRProgram) -> SDEPlan:
    prog.rebuild_channels()
    # map comm -> send node id for level propagation
    send_of_comm = {cid: (ssi, snid) for cid, (ssi, snid, _, _) in prog.channels.items()}

    # global topological order across segments (follow channels send->recv)
    nodes: Dict[int, IR.IRNode] = {}
    seg_of: Dict[int, IR.Segment] = {}
    for seg in prog.segments:
        for n in seg.nodes.values():
            nodes[n.id] = n
            seg_of[n.id] = seg

    def deps(n: IR.IRNode) -> List[int]:
        if n.is_recv():
            ssi, snid = send_of_comm[n.comm_id]
            return [snid]
        return list(n.inputs)

    # Kahn over the global graph
    indeg = {nid: 0 for nid in nodes}
    succ: Dict[int, List[int]] = {nid: [] for nid in nodes}
    for n in nodes.values():
        for d in deps(n):
            indeg[n.id] += 1
            succ[d].append(n.id)
    frontier = collections.deque(nid for nid, d in sorted(indeg.items()) if d == 0)
    order: List[int] = []
    while frontier:
        nid = frontier.popleft()
        order.append(nid)
        for s in sorted(succ[nid]):
            indeg[s] -= 1
            if indeg[s] == 0:
                frontier.append(s)
    if len(order) != len(nodes):
        raise ValueError("global IR graph has a cycle")

    # levels: recvInEdge (gather result) is available one barrier later
    level: Dict[int, int] = {}
    for nid in order:
        n = nodes[nid]
        base = max((level[d] for d in deps(n)), default=0)
        if n.op == "recvInEdge":
            base += 1
        level[nid] = base

    # roles for vertex nodes: src if it transitively feeds a sendOutEdge,
    # dst if it feeds a sendInEdge / output, or consumes a recvInEdge.
    role: Dict[int, Set[str]] = {nid: set() for nid in nodes}
    # backward propagation over the global graph
    for nid in reversed(order):
        n = nodes[nid]
        if seg_of[nid].kind == "vertex":
            if n.op == "sendOutEdge":
                role[nid].add("src")
            if n.op == "sendInEdge" or n.op == "output" or n.op.startswith("sendDst"):
                role[nid].add("dst")
        for d in deps(n):
            if seg_of[d].kind == "vertex" and seg_of[nid].kind == "vertex":
                role[d] |= role[nid]
            elif seg_of[d].kind == "vertex":
                # vertex value consumed by an edge segment via a send — the
                # role came from the send node itself; nothing to add here.
                pass
    # vertex nodes consuming gather results are dst-side by construction
    for nid, n in nodes.items():
        if seg_of[nid].kind == "vertex" and n.op == "recvInEdge":
            role[nid].add("dst")

    max_level = max(level.values()) if level else 0
    return SDEPlan(prog=prog, level=level, role=role, max_level=max_level)


# ---------------------------------------------------------------------------
# Top-level compile entry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledGNN:
    name: str
    trace: TR.GnnTrace
    naive_ir: IR.IRProgram
    ir: IR.IRProgram          # optimized
    plan: SDEPlan
    opt_report: Dict[str, int]
    #: verify schedules as they are lowered (set from compile_gnn(verify=))
    verify: bool = True
    #: non-fatal findings accumulated by the verification hooks
    diagnostics: List = dataclasses.field(default_factory=list, repr=False)
    _schedules: Dict[bool, object] = dataclasses.field(default_factory=dict,
                                                       repr=False)

    @property
    def n_layers(self) -> int:
        """GNN layers in the lowered program (stacked models; 1 otherwise)."""
        return self.trace.n_layers

    def schedule(self, kernel_dispatch: bool = True):
        """The :class:`~repro.core.schedule.ScheduledProgram` every engine
        interprets (cached per dispatch mode)."""
        from . import schedule as S

        key = bool(kernel_dispatch)
        if key not in self._schedules:
            sp = S.lower(self.plan, kernel_dispatch=key)
            if self.verify:
                from . import analysis as A

                diags = A.verify_schedule(sp)
                errs = A.errors(diags)
                if errs:
                    raise A.VerificationError(
                        diags, context=f"schedule({self.name}, "
                                       f"kernel_dispatch={key})")
                self.diagnostics.extend(diags)
            self._schedules[key] = sp
        return self._schedules[key]

    def structure_signature(self, kernel_dispatch: bool = True):
        """Structural identity of the scheduled program (serving-cache hook):
        two compiled models with equal signatures lower to interchangeable
        programs, so warm runners can be shared between them."""
        return self.schedule(kernel_dispatch).structure_signature()


def compile_gnn(tr: TR.GnnTrace, optimize: bool = True,
                verify: bool = True) -> CompiledGNN:
    """Compile a (possibly multi-layer) whole-graph trace end to end: one
    cross-layer CSE pass on the trace, one IR spanning every layer, one
    SDE plan — engines interpret the whole stack in a single program.

    With ``verify=True`` (the default) the static IR verifier runs over the
    optimized program — and the schedule verifier over each lowering as it
    is produced — raising :class:`~repro.core.analysis.VerificationError`
    on any error-severity diagnostic.  Warnings/infos accumulate on
    ``CompiledGNN.diagnostics``.  The passes are pure graph walks (no
    execution), so the hook is cheap enough to stay on everywhere.
    """
    from . import passes

    naive = construct_ir(tr)
    if optimize:
        deduped, cse_removed = passes.cse_trace(tr)
        opt, report = passes.optimize(construct_ir(deduped))
        report["cse_removed"] = cse_removed
    else:
        opt, report = naive, {"e2v_moved": 0, "dce_removed": 0, "cse_removed": 0}
    if verify:
        from . import analysis as A

        diags = A.verify_ir(opt)
        errs = A.errors(diags)
        if errs:
            raise A.VerificationError(diags, context=f"compile_gnn({tr.name})")
    plan = plan_sde(opt)
    compiled = CompiledGNN(name=tr.name, trace=tr, naive_ir=naive, ir=opt,
                           plan=plan, opt_report=report, verify=verify)
    if verify:
        compiled.diagnostics.extend(diags)
    return compiled
