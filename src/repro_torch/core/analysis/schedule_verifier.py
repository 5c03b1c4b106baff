"""ScheduledProgram verifier (ISSUE 6 pass 2).

Independently re-checks what :func:`repro.core.schedule.lower` and its
pattern matcher promise, straight from the IR — gather-block ownership,
covered/fused-level consistency, kernel-tag legality (the Pallas kernel
preconditions are re-derived here, never trusted from
``_match_softmax_motifs`` / ``_classify_gather``), and the
published-before-read dataflow contract every engine relies on.  Also home
of the **missed-kernel lint** (ZS110): for every scan-fallback gather under
``kernel_dispatch=True`` it explains *why* pattern matching failed.  The
lint is schedule-level, so it covers every engine that executes the
kernel-dispatch variant — :class:`~repro.core.pipeline.PipelinedRunner` and
the sharded ``shard_map`` path alike — and feeds the
:mod:`repro.launch.autotune` search, which only tunes schedules whose
gathers actually kernelized.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .. import ir as IR
from .. import schedule as S
from .diagnostics import Diagnostic

_GATHER_SENDS = ("sendDstSum", "sendDstMax", "sendDstMean")


class _Ctx:
    """Shared lookups over the scheduled program's IR."""

    def __init__(self, sp: S.ScheduledProgram):
        self.sp = sp
        self.nodes: Dict[int, IR.IRNode] = {}
        self.seg_kind: Dict[int, str] = {}
        for seg in sp.prog.segments:
            for n in seg.nodes.values():
                self.nodes[n.id] = n
                self.seg_kind[n.id] = seg.kind
        self.consumers: Dict[int, List[IR.IRNode]] = {}
        for n in self.nodes.values():
            for i in n.inputs:
                self.consumers.setdefault(i, []).append(n)
        self.send_of_comm: Dict[int, int] = {}
        self.recv_of_comm: Dict[int, int] = {}
        for n in self.nodes.values():
            if n.comm_id is None:
                continue
            if n.is_send():
                self.send_of_comm[n.comm_id] = n.id
            elif n.is_recv():
                self.recv_of_comm[n.comm_id] = n.id

    def only_consumer(self, nid: int) -> Optional[IR.IRNode]:
        cons = self.consumers.get(nid, [])
        return cons[0] if len(cons) == 1 else None

    def src_value_of_recv(self, rs: IR.IRNode) -> Optional[int]:
        """recvSrc node -> the vertex node id its scatter send reads."""
        sid = self.send_of_comm.get(rs.comm_id)
        return self.nodes[sid].inputs[0] if sid is not None else None


# ---------------------------------------------------------------------------
# kernel-tag legality: re-derive the preconditions from the IR
# ---------------------------------------------------------------------------

def _check_spmm(g: S.GatherBlock, ctx: _Ctx) -> Optional[str]:
    send = ctx.nodes.get(g.acc.send_id)
    if send is None or send.op != "sendDstSum":
        return f"send is {getattr(send, 'op', '<missing>')}, needs sendDstSum"
    val = ctx.nodes.get(send.inputs[0])
    if val is None or val.op != "recvSrc":
        return f"gather operand is {getattr(val, 'op', '<missing>')}, " \
               f"needs a private recvSrc"
    if ctx.only_consumer(val.id) is not send:
        return f"recvSrc %{val.id} has {len(ctx.consumers.get(val.id, []))} " \
               f"consumers, must feed only the send"
    want_src = ctx.src_value_of_recv(val)
    if g.src_value_id != want_src:
        return f"src_value_id %{g.src_value_id} != scatter source %{want_src}"
    if g.covered != {val.id, send.id}:
        return f"covered {sorted(g.covered)} != {{%{val.id}, %{send.id}}}"
    return None


def _check_spmm_weighted(g: S.GatherBlock, ctx: _Ctx) -> Optional[str]:
    send = ctx.nodes.get(g.acc.send_id)
    if send is None or send.op != "sendDstSum":
        return f"send is {getattr(send, 'op', '<missing>')}, needs sendDstSum"
    val = ctx.nodes.get(send.inputs[0])
    if val is None or val.op != "mul":
        return f"gather operand is {getattr(val, 'op', '<missing>')}, " \
               f"needs recvSrc * weight"
    if ctx.only_consumer(val.id) is not send:
        return f"mul %{val.id} has {len(ctx.consumers.get(val.id, []))} " \
               f"consumers, must feed only the send"
    a, b = (ctx.nodes[i] for i in val.inputs)
    for rs, w in ((a, b), (b, a)):
        if (rs.op == "recvSrc" and w.dim == 1 and not w.is_recv()
                and ctx.only_consumer(rs.id) is val):
            if g.weight_id != w.id:
                return f"weight_id %{g.weight_id} != per-edge scalar %{w.id}"
            want_src = ctx.src_value_of_recv(rs)
            if g.src_value_id != want_src:
                return (f"src_value_id %{g.src_value_id} != scatter source "
                        f"%{want_src}")
            if g.covered != {val.id, rs.id, send.id}:
                return (f"covered {sorted(g.covered)} != "
                        f"{{%{val.id}, %{rs.id}, %{send.id}}}")
            return None
    return (f"mul %{val.id} operands ({a.op} dim={a.dim}, {b.op} dim={b.dim})"
            f" are not recvSrc x private per-edge scalar")


def _walk_softmax(score_id: int, ctx: _Ctx
                  ) -> Tuple[Optional[Dict], Optional[str]]:
    """Forward-walk the fused edge-softmax motif from its raw score node.

    Returns ``(derived, None)`` on success — ``derived`` holds the out send,
    covered set and source value — or ``(None, reason)`` naming the first
    broken link (shared with the missed-kernel lint for sendDstMax fallbacks).
    """
    nodes, only = ctx.nodes, ctx.only_consumer
    e0 = nodes.get(score_id)
    if e0 is None:
        return None, f"score node %{score_id} does not exist"
    cons = ctx.consumers.get(score_id, [])
    smax = next((c for c in cons if c.op == "sendDstMax"), None)
    sub = next((c for c in cons if c.op == "sub"), None)
    if smax is None or sub is None or len(cons) != 2:
        return None, (f"score %{score_id} must feed exactly {{sendDstMax, "
                      f"sub}}, feeds {[c.op for c in cons]}")
    m_recv_id = ctx.recv_of_comm.get(smax.comm_id)
    if m_recv_id is None:
        return None, f"max-gather comm {smax.comm_id} has no recv"
    m_send = only(m_recv_id)
    if m_send is None or m_send.op not in ("sendInEdge", "sendOutEdge"):
        return None, (f"max result %{m_recv_id} must feed exactly one "
                      f"scatter back to the edges")
    m_edge = nodes[ctx.recv_of_comm[m_send.comm_id]]
    if m_edge.op != "recvDst":
        return None, f"max result scatters via {m_edge.op}, needs recvDst"
    if sub.inputs != [score_id, m_edge.id] or only(m_edge.id) is not sub:
        return None, (f"shift must be sub(score, max) with a private max "
                      f"scatter; got sub{sub.inputs}")
    ex = only(sub.id)
    if ex is None or ex.op != "exp":
        return None, f"shifted score must feed exactly one exp"
    ex_cons = ctx.consumers.get(ex.id, [])
    ssum = next((c for c in ex_cons if c.op == "sendDstSum"), None)
    div = next((c for c in ex_cons if c.op == "div"), None)
    if ssum is None or div is None or len(ex_cons) != 2:
        return None, (f"exp %{ex.id} must feed exactly {{sendDstSum, div}}, "
                      f"feeds {[c.op for c in ex_cons]}")
    s_recv_id = ctx.recv_of_comm.get(ssum.comm_id)
    s_send = only(s_recv_id) if s_recv_id is not None else None
    if s_send is None or s_send.op not in ("sendInEdge", "sendOutEdge"):
        return None, (f"sum result %{s_recv_id} must feed exactly one "
                      f"scatter back to the edges")
    s_edge = nodes[ctx.recv_of_comm[s_send.comm_id]]
    if (s_edge.op != "recvDst" or div.inputs != [ex.id, s_edge.id]
            or only(s_edge.id) is not div):
        return None, f"normalizer must be div(exp, private recvDst(sum))"
    mul = only(div.id)
    if mul is None or mul.op != "mul":
        return None, f"alpha %{div.id} must feed exactly one mul"
    other = [i for i in mul.inputs if i != div.id]
    if len(other) != 1:
        return None, f"mul %{mul.id} must pair alpha with one message"
    rs = nodes[other[0]]
    if rs.op != "recvSrc" or only(rs.id) is not mul:
        return None, f"message operand is {rs.op}, needs a private recvSrc"
    out_send = only(mul.id)
    if out_send is None or out_send.op != "sendDstSum":
        return None, f"weighted message must feed exactly one sendDstSum"
    covered = {smax.id, m_recv_id, m_send.id, m_edge.id, sub.id, ex.id,
               ssum.id, s_recv_id, s_send.id, s_edge.id, div.id, rs.id,
               mul.id, out_send.id, ctx.send_of_comm[rs.comm_id]}
    return {"out_send": out_send, "covered": covered,
            "src_value_id": ctx.src_value_of_recv(rs),
            "max_send": smax}, None


def _check_softmax(g: S.GatherBlock, phase: S.Phase, ctx: _Ctx,
                   plan) -> Optional[str]:
    if g.score_id is None:
        return "block carries no score_id"
    derived, reason = _walk_softmax(g.score_id, ctx)
    if derived is None:
        return reason
    if derived["out_send"].id != g.acc.send_id:
        return (f"acc.send_id %{g.acc.send_id} != motif output send "
                f"%{derived['out_send'].id}")
    if g.src_value_id != derived["src_value_id"]:
        return (f"src_value_id %{g.src_value_id} != message source "
                f"%{derived['src_value_id']}")
    if g.covered != derived["covered"]:
        missing = sorted(derived["covered"] - g.covered)
        extra = sorted(g.covered - derived["covered"])
        return f"covered set wrong (missing {missing}, extra {extra})"
    lvl = plan.level.get(derived["max_send"].id)
    if g.fused_levels != (lvl, lvl + 1, lvl + 2):
        return (f"fused_levels {g.fused_levels} != ({lvl}, {lvl + 1}, "
                f"{lvl + 2}) from the max-gather level")
    if phase.level != lvl:
        return f"block scheduled at phase {phase.level}, motif head at {lvl}"
    return None


_KERNEL_CHECKS = {
    S.KERNEL_SPMM: ("ZS104", lambda g, p, ctx, plan: _check_spmm(g, ctx)),
    S.KERNEL_SPMM_WEIGHTED: ("ZS105",
                             lambda g, p, ctx, plan: _check_spmm_weighted(g, ctx)),
    S.KERNEL_SEGMENT_SOFTMAX: ("ZS106", _check_softmax),
}


def explain_scan_fallback(g: S.GatherBlock, ctx: _Ctx) -> str:
    """Why this gather did NOT dispatch to a Pallas kernel (ZS110 lint)."""
    send = ctx.nodes.get(g.acc.send_id)
    if send is None:
        return f"send %{g.acc.send_id} missing from the IR"
    if send.op == "sendDstMean":
        return "mean-reduce gathers have no dedicated kernel (sum + count)"
    if send.op == "sendDstMax":
        _, reason = _walk_softmax(send.inputs[0], ctx)
        return (f"max-reduce alone has no kernel, and the edge-softmax "
                f"motif does not match: {reason}" if reason else
                "max-reduce gather (softmax head handled elsewhere)")
    val = ctx.nodes.get(send.inputs[0])
    if val is None:
        return f"gather operand %{send.inputs[0]} missing from the IR"
    if val.op == "recvSrc":
        cons = ctx.consumers.get(val.id, [])
        return (f"recvSrc message %{val.id} has {len(cons)} consumers "
                f"({[c.op for c in cons]}) — pallas_spmm needs it private "
                f"to the gather")
    if val.op == "mul":
        if ctx.only_consumer(val.id) is not send:
            return (f"weighted message %{val.id} has "
                    f"{len(ctx.consumers.get(val.id, []))} consumers — "
                    f"pallas_spmm_weighted needs it private to the gather")
        a, b = (ctx.nodes[i] for i in val.inputs)
        ops = f"({a.op} dim={a.dim}) * ({b.op} dim={b.dim})"
        if not any(n.op == "recvSrc" for n in (a, b)):
            return f"mul {ops} has no recvSrc message operand"
        rs = a if a.op == "recvSrc" else b
        w = b if rs is a else a
        if ctx.only_consumer(rs.id) is not val:
            return f"recvSrc %{rs.id} is shared beyond the weighted message"
        if w.is_recv():
            return (f"weight operand %{w.id} is a {w.op} — the kernel "
                    f"densifies only edge-computed scalars")
        return (f"weight operand %{w.id} has dim {w.dim} — the densified "
                f"adjacency needs a per-edge scalar (dim 1)")
    return (f"gather operand is {val.op!r} — no kernel matches "
            f"(pallas_spmm wants recvSrc, pallas_spmm_weighted recvSrc * a)")


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------

def verify_schedule(sp: S.ScheduledProgram) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    ctx = _Ctx(sp)
    plan = sp.plan

    def gather_anchor(phase: S.Phase, g: S.GatherBlock) -> Dict:
        return dict(phase=phase.level, node=g.acc.send_id,
                    block=f"gather[comm={g.acc.comm_id}]", origin="schedule")

    all_blocks: List[Tuple[S.Phase, S.GatherBlock]] = [
        (p, g) for p in sp.phases for g in p.gathers]

    # --- accumulator specs vs the IR (ZS111) -------------------------------
    for phase, g in all_blocks:
        send = ctx.nodes.get(g.acc.send_id)
        anchor = gather_anchor(phase, g)
        if send is None or send.op not in _GATHER_SENDS:
            diags.append(Diagnostic(
                "ZS111", f"acc.send_id %{g.acc.send_id} is not a gather "
                         f"send", **anchor))
            continue
        kind = IR.GATHER_REDUCE[send.op]
        if g.acc.kind != kind:
            diags.append(Diagnostic(
                "ZS111", f"acc kind {g.acc.kind!r} != {kind!r} of "
                         f"{send.op}", **anchor))
        if g.acc.dim != send.dim:
            diags.append(Diagnostic(
                "ZS111", f"acc dim {g.acc.dim} != send dim {send.dim}",
                **anchor))
        if g.acc.value_id != send.inputs[0]:
            diags.append(Diagnostic(
                "ZS111", f"acc value %{g.acc.value_id} != send operand "
                         f"%{send.inputs[0]}", **anchor))
        if (g.acc.comm_id != send.comm_id
                or ctx.recv_of_comm.get(send.comm_id) != g.acc.recv_id):
            diags.append(Diagnostic(
                "ZS111", f"acc channel (comm={g.acc.comm_id}, "
                         f"recv=%{g.acc.recv_id}) != IR channel "
                         f"(comm={send.comm_id}, "
                         f"recv=%{ctx.recv_of_comm.get(send.comm_id)})",
                **anchor))

    # --- ownership: every gather channel in exactly one block (ZS101) ------
    gather_sends = sorted(n.id for n in ctx.nodes.values()
                          if n.op in _GATHER_SENDS)
    for snid in gather_sends:
        owners = [(p, g) for p, g in all_blocks
                  if g.acc.send_id == snid or snid in g.covered]
        if len(owners) != 1:
            where = [f"phase {p.level}/comm {g.acc.comm_id}"
                     for p, g in owners]
            diags.append(Diagnostic(
                "ZS101", f"gather send %{snid} "
                         f"({ctx.nodes[snid].op}, comm "
                         f"{ctx.nodes[snid].comm_id}) owned by "
                         f"{len(owners)} blocks {where}, need exactly 1",
                node=snid, origin="schedule"))

    # --- covered sets pairwise disjoint (ZS102) ----------------------------
    seen_covered: Dict[int, Tuple[S.Phase, S.GatherBlock]] = {}
    for phase, g in all_blocks:
        for nid in sorted(g.covered):
            if nid in seen_covered:
                p0, g0 = seen_covered[nid]
                diags.append(Diagnostic(
                    "ZS102", f"%{nid} covered by both phase {p0.level}/"
                             f"comm {g0.acc.comm_id} and this block",
                    **gather_anchor(phase, g)))
            else:
                seen_covered[nid] = (phase, g)

    # --- fused_levels / level consistency (ZS103) --------------------------
    levels = {p.level for p in sp.phases}
    for phase, g in all_blocks:
        anchor = gather_anchor(phase, g)
        if g.kernel == S.KERNEL_SEGMENT_SOFTMAX:
            want = (phase.level, phase.level + 1, phase.level + 2)
            if g.fused_levels != want:
                diags.append(Diagnostic(
                    "ZS103", f"fused_levels {g.fused_levels} != {want}",
                    **anchor))
            elif not set(g.fused_levels) <= levels:
                diags.append(Diagnostic(
                    "ZS103", f"fused_levels {g.fused_levels} name phases "
                             f"that do not exist", **anchor))
        elif g.fused_levels:
            diags.append(Diagnostic(
                "ZS103", f"non-fused {g.kernel} block carries fused_levels "
                         f"{g.fused_levels}", **anchor))
        elif (g.acc.send_id in ctx.nodes
              and plan.level.get(g.acc.send_id) != phase.level):
            diags.append(Diagnostic(
                "ZS103", f"send %{g.acc.send_id} has gather level "
                         f"{plan.level.get(g.acc.send_id)} but is scheduled "
                         f"at phase {phase.level}", **anchor))

    # --- kernel-tag legality (ZS104/105/106) + missed-kernel lint (ZS110) --
    for phase, g in all_blocks:
        if g.kernel == S.KERNEL_SCAN:
            if sp.kernel_dispatch:
                diags.append(Diagnostic(
                    "ZS110", explain_scan_fallback(g, ctx),
                    **gather_anchor(phase, g)))
            continue
        if g.kernel not in _KERNEL_CHECKS:
            diags.append(Diagnostic(
                "ZS104", f"unknown kernel tag {g.kernel!r}",
                **gather_anchor(phase, g)))
            continue
        code, check = _KERNEL_CHECKS[g.kernel]
        reason = check(g, phase, ctx, plan)
        if reason:
            diags.append(Diagnostic(
                code, f"{g.kernel} illegal here: {reason}",
                **gather_anchor(phase, g)))

    # --- covered nodes must not leak into any executed block (ZS109) -------
    covered_all: Set[int] = set()
    for _, g in all_blocks:
        covered_all |= g.covered
    for phase in sp.phases:
        for role, nodes in (("src", phase.src.nodes),
                            ("edge", phase.edge.nodes),
                            ("dst", phase.dst.nodes)):
            leaked = sorted(n.id for n in nodes if n.id in covered_all)
            for nid in leaked:
                diags.append(Diagnostic(
                    "ZS109", f"%{nid} ({ctx.nodes[nid].op}) is kernel-"
                             f"covered but still scheduled here",
                    phase=phase.level, node=nid, block=role,
                    origin="schedule"))
        for g in phase.gathers:
            for n in g.edge_nodes:
                if n.id in covered_all:
                    diags.append(Diagnostic(
                        "ZS109", f"%{n.id} ({n.op}) is kernel-covered but "
                                 f"listed in this block's edge operands",
                        **gather_anchor(phase, g)))

    # --- phase layer tags monotone (ZS108) ---------------------------------
    last_layer = 0
    for phase in sp.phases:
        if phase.layer < last_layer:
            diags.append(Diagnostic(
                "ZS108", f"layer tag {phase.layer} after a phase of layer "
                         f"{last_layer}", phase=phase.level,
                origin="schedule"))
        last_layer = max(last_layer, phase.layer)
    if sp.phases and sp.n_layers != sp.phases[-1].layer + 1:
        diags.append(Diagnostic(
            "ZS108", f"program claims {sp.n_layers} layers but the last "
                     f"phase is tagged layer {sp.phases[-1].layer}",
            phase=sp.phases[-1].level, origin="schedule"))

    # --- published-before-read dataflow (ZS107) ----------------------------
    diags.extend(_verify_dataflow(sp, ctx))
    return diags


def _verify_dataflow(sp: S.ScheduledProgram, ctx: _Ctx) -> List[Diagnostic]:
    """The engines' availability contract: every read resolves to a value
    that an earlier (or the same) phase provably produced or published."""
    diags: List[Diagnostic] = []
    vertex_inputs = {nid for nid, _ in sp.vertex_inputs}
    edge_inputs = {nid for nid, _ in sp.edge_inputs}

    #: recvInEdge id -> index of the phase whose gather block produces it
    produced_at: Dict[int, int] = {}
    #: dst-published node id -> first phase index it lands in the store
    published_at: Dict[int, int] = {}
    for pi, phase in enumerate(sp.phases):
        for g in phase.gathers:
            produced_at.setdefault(g.acc.recv_id, pi)
        for nid in phase.dst.store_ids:
            published_at.setdefault(nid, pi)

    def avail_vertex(nid: int, pi: int, src_side: bool,
                     same_phase_store: bool) -> bool:
        """Can a vertex-store read of ``nid`` resolve at phase index ``pi``?
        ``src_side`` additionally allows per-tile recompute via the phase's
        cumulative src block; ``same_phase_store`` allows store_ids of the
        *current* phase (the dst block runs before the tile work)."""
        if nid in vertex_inputs:
            return True
        if nid in produced_at and produced_at[nid] < pi:
            return True
        limit = pi if same_phase_store else pi - 1
        if nid in published_at and published_at[nid] <= limit:
            return True
        if src_side:
            return nid in {n.id for n in sp.phases[pi].src.nodes}
        return False

    for pi, phase in enumerate(sp.phases):
        src_ids = {n.id for n in phase.src.nodes}
        dst_ids = {n.id for n in phase.dst.nodes}

        # dst block: runs first, reads gather results of EARLIER phases
        for n in phase.dst.fresh:
            for i in n.inputs:
                if i in dst_ids or i in vertex_inputs:
                    continue
                if i in produced_at and produced_at[i] < pi:
                    continue
                why = (f"gather result %{i} is produced at phase "
                       f"{sp.phases[produced_at[i]].level}"
                       if i in produced_at else f"%{i} is never published")
                diags.append(Diagnostic(
                    "ZS107", f"dst {n.op} %{n.id} reads %{i} before it is "
                             f"available ({why})",
                    phase=phase.level, node=n.id, block="dst",
                    origin="schedule"))

        # src block: per-tile recompute falls back to the published store
        for n in phase.src.fresh:
            for i in n.inputs:
                if i in src_ids:
                    continue
                if not avail_vertex(i, pi, src_side=False,
                                    same_phase_store=True):
                    diags.append(Diagnostic(
                        "ZS107", f"src {n.op} %{n.id} reads %{i}, which no "
                                 f"phase <= {phase.level} publishes",
                        phase=phase.level, node=n.id, block="src",
                        origin="schedule"))

        # edge lists: scan path and kernel operand closures
        for block, enodes in ([("edge", phase.edge.nodes)]
                              + [(f"gather[comm={g.acc.comm_id}]",
                                  g.edge_nodes) for g in phase.gathers]):
            listed: Set[int] = set()
            for n in enodes:
                if n.op in ("recvSrc", "recvDst"):
                    v = sp.scatter_value_of.get(n.id)
                    ok = v is not None and avail_vertex(
                        v, pi, src_side=(n.op == "recvSrc"),
                        same_phase_store=True)
                    if not ok:
                        diags.append(Diagnostic(
                            "ZS107", f"{n.op} %{n.id} scatters %{v}, which "
                                     f"no phase <= {phase.level} provides",
                            phase=phase.level, node=n.id, block=block,
                            origin="schedule"))
                elif n.op == "recvInEdge":
                    diags.append(Diagnostic(
                        "ZS107", f"gather result %{n.id} listed as edge "
                                 f"compute", phase=phase.level, node=n.id,
                        block=block, origin="schedule"))
                else:
                    for i in n.inputs:
                        if i not in listed and i not in edge_inputs:
                            diags.append(Diagnostic(
                                "ZS107", f"edge {n.op} %{n.id} reads %{i} "
                                         f"before this block computes it",
                                phase=phase.level, node=n.id, block=block,
                                origin="schedule"))
                listed.add(n.id)

        # gather operands: X values and scan/edge value availability
        for g in phase.gathers:
            anchor = dict(phase=phase.level, node=g.acc.send_id,
                          block=f"gather[comm={g.acc.comm_id}]",
                          origin="schedule")
            if g.src_value_id is not None and not avail_vertex(
                    g.src_value_id, pi, src_side=True, same_phase_store=True):
                diags.append(Diagnostic(
                    "ZS107", f"kernel X operand %{g.src_value_id} is not "
                             f"available at phase {phase.level}", **anchor))
            if g.kernel == S.KERNEL_SCAN:
                have = {n.id for n in phase.edge.nodes} | edge_inputs
                if g.acc.value_id not in have:
                    diags.append(Diagnostic(
                        "ZS107", f"scan gather value %{g.acc.value_id} is "
                                 f"not computed by this phase's edge block",
                        **anchor))
            for ref, what in ((g.weight_id, "weight"), (g.score_id, "score")):
                if ref is None:
                    continue
                have = {n.id for n in g.edge_nodes} | edge_inputs
                if ref not in have:
                    diags.append(Diagnostic(
                        "ZS107", f"kernel {what} operand %{ref} is not in "
                                 f"the block's edge closure", **anchor))

    # outputs must be published by some phase
    for o in sp.outputs:
        if o not in published_at:
            diags.append(Diagnostic(
                "ZS107", f"output %{o} is never published by any phase's "
                         f"store_ids", node=o, block="dst",
                origin="schedule"))
    return diags
