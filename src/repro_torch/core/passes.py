"""Optimization passes (paper §6.2).

* Cross-layer CSE (trace level): value-number the whole-graph trace and
  deduplicate ops that recompute an identical value — in stacked models the
  structure-only work (the shared ``dnorm`` scaling, the re-scattered
  unchanged normalized adjacency between GCN layers) repeats per layer and
  collapses to one copy.  Running before GOP defusion means the duplicate
  send/recv channels are never even built.
* E2V (edge-to-vertex): hoist edge-segment ops whose inputs are pure
  source- (or pure destination-) functions into the corresponding vertex
  segment, before the scatter.  Eliminates per-edge redundant compute —
  an op on E edges becomes an op on (at most) V vertices.
* DCE: global dead-code elimination across segments/channels (cleans up the
  orphaned send/recv pairs E2V leaves behind).

E2V and DCE operate on the whole IR program — segments of every layer at
once — so for multi-layer lowerings they hoist and sweep across layer
boundaries for free.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Set, Tuple

from . import ir as IR
from . import trace as TR

_SCATTER_RECVS = ("recvSrc", "recvDst")


def cse_trace(tr: TR.GnnTrace) -> Tuple[TR.GnnTrace, int]:
    """Cross-layer common-subexpression elimination on the whole-graph trace.

    Two nodes are equal when op, space, (remapped) inputs, dim, and attrs all
    match — every traced op (GOPs included) is a pure function of its inputs
    and the symbolic graph, so the later copy can reuse the earlier value.
    Inputs/params are keyed by name; ``output`` indicators are never merged.
    A merged node keeps the *earliest* emitter's layer tag, so deduplicated
    structure-only work is scheduled with the first layer that needs it.

    Returns ``(deduplicated trace, number of nodes removed)``.
    """
    new = TR.GnnTrace(name=tr.name)
    new.params = dict(tr.params)
    remap: Dict[int, int] = {}
    seen: Dict[tuple, int] = {}
    removed = 0
    for n in tr.nodes:
        inputs = tuple(remap[i] for i in n.inputs)
        if n.op == "output":
            key = None                       # keep declaration order/arity
        elif n.op in ("input", "param"):
            key = (n.op, n.space, n.attrs["name"])
        else:
            key = (n.op, n.space, inputs, n.dim,
                   tuple(sorted((k, repr(v)) for k, v in n.attrs.items())))
        if key is not None and key in seen:
            remap[n.id] = seen[key]
            removed += 1
            continue
        nid = len(new.nodes)
        new.nodes.append(TR.TNode(id=nid, op=n.op, space=n.space,
                                  inputs=list(inputs), attrs=dict(n.attrs),
                                  dim=n.dim))
        new.layer_of[nid] = tr.layer_of.get(n.id, 0)
        remap[n.id] = nid
        if key is not None:
            seen[key] = nid
    dedup_inputs: List[int] = []
    for i in tr.inputs:
        if remap[i] not in dedup_inputs:
            dedup_inputs.append(remap[i])
    new.inputs = dedup_inputs
    new.outputs = [remap[o] for o in tr.outputs]
    return new, removed


def _seg_index(prog: IR.IRProgram, seg: IR.Segment) -> int:
    return prog.segments.index(seg)


def global_dce(prog: IR.IRProgram) -> int:
    """Remove nodes not backward-reachable from any ``output``. Returns count."""
    prog.rebuild_channels()
    send_of_comm = {cid: snid for cid, (ssi, snid, _, _) in prog.channels.items()}
    nodes: Dict[int, IR.IRNode] = {}
    for seg in prog.segments:
        nodes.update(seg.nodes)

    def deps(n: IR.IRNode) -> List[int]:
        if n.is_recv():
            return [send_of_comm[n.comm_id]]
        return list(n.inputs)

    live: Set[int] = set()
    stack = [n.id for n in nodes.values() if n.op == "output"]
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        stack.extend(deps(nodes[nid]))

    removed = 0
    for seg in prog.segments:
        dead = [nid for nid in seg.nodes if nid not in live]
        for nid in dead:
            del seg.nodes[nid]
            removed += 1
    prog.segments = [s for s in prog.segments if s.nodes]
    prog.rebuild_channels()
    return removed


def _consumers(seg: IR.Segment, nid: int) -> List[IR.IRNode]:
    return [n for n in seg.nodes.values() if nid in n.inputs]


def e2v(prog: IR.IRProgram) -> int:
    """Edge-to-vertex hoisting. Returns the number of ops moved.

    A computational node in an edge segment is hoistable when every input is
    a scatter ``recv`` of one kind (all ``recvSrc`` or all ``recvDst``) whose
    paired sends live in the same vertex segment.  The op is then replayed on
    the vertex side (before the scatter) and a fresh scatter channel carries
    the already-computed value to the remaining edge consumers.
    """
    moved = 0
    changed = True
    while changed:
        changed = False
        prog.rebuild_channels()
        send_loc = {cid: (ssi, snid) for cid, (ssi, snid, _, _) in prog.channels.items()}
        for eseg in prog.edge_segments():
            for n in list(eseg.nodes.values()):
                if n.op not in IR.COMPUTE_OPS or not n.inputs:
                    continue
                ins = [eseg.nodes.get(i) for i in n.inputs]
                if any(m is None or not m.is_recv() or m.op not in _SCATTER_RECVS for m in ins):
                    continue
                kinds = {m.op for m in ins}
                if len(kinds) != 1:
                    continue
                vsegs = {send_loc[m.comm_id][0] for m in ins}
                if len(vsegs) != 1:
                    continue
                vsi = vsegs.pop()
                vseg = prog.segments[vsi]
                sends = [vseg.nodes[send_loc[m.comm_id][1]] for m in ins]
                # replay op on the vertex side, on the pre-scatter values
                hoisted = IR.IRNode(
                    id=prog.fresh_id(), op=n.op,
                    inputs=[s.inputs[0] for s in sends],
                    dim=n.dim, attrs=dict(n.attrs), layer=n.layer)
                vseg.add(hoisted)
                # fresh scatter channel for the computed value
                cid = prog.fresh_comm()
                new_send = IR.IRNode(id=prog.fresh_id(), op=sends[0].op,
                                     inputs=[hoisted.id], dim=n.dim, comm_id=cid,
                                     layer=n.layer)
                vseg.add(new_send)
                new_recv = IR.IRNode(id=prog.fresh_id(), op=ins[0].op, inputs=[],
                                     dim=n.dim, comm_id=cid, layer=n.layer)
                eseg.add(new_recv)
                for c in _consumers(eseg, n.id):
                    c.inputs = [new_recv.id if i == n.id else i for i in c.inputs]
                del eseg.nodes[n.id]
                moved += 1
                changed = True
                break  # channel table is stale — rescan from a clean slate
            if changed:
                break
        if changed:
            global_dce(prog)
    return moved


def fuse_elementwise(prog: IR.IRProgram) -> List[List[int]]:
    """Group chains of single-consumer element-wise ops (per segment).

    Purely advisory: the groups are consumed by the simulator / ISA codegen
    (one fused VU instruction per group) — the IR itself is left untouched,
    mirroring how the paper applies "existing DL optimizations" on the IR.
    """
    groups: List[List[int]] = []
    for seg in prog.segments:
        consumed: Set[int] = set()
        cons_count: Dict[int, int] = {}
        for n in seg.nodes.values():
            for i in n.inputs:
                cons_count[i] = cons_count.get(i, 0) + 1
        for n in seg.toposort():
            if n.id in consumed or n.op not in (IR.ELW_UNARY + IR.ELW_BINARY):
                continue
            chain = [n.id]
            cur = n
            while True:
                nxt = [c for c in _consumers(seg, cur.id)
                       if c.op in (IR.ELW_UNARY + IR.ELW_BINARY)
                       and cons_count.get(cur.id, 0) == 1]
                if len(nxt) != 1:
                    break
                cur = nxt[0]
                chain.append(cur.id)
            consumed.update(chain)
            if len(chain) > 1:
                groups.append(chain)
    return groups


def optimize(prog: IR.IRProgram) -> Tuple[IR.IRProgram, Dict[str, int]]:
    opt = copy.deepcopy(prog)
    moved = e2v(opt)
    removed = global_dce(opt)
    opt.validate()
    return opt, {"e2v_moved": moved, "dce_removed": removed,
                 "fusion_groups": len(fuse_elementwise(opt))}
