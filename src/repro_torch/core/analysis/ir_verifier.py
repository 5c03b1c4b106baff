"""IR verifier (ISSUE 6 pass 1): def-use dataflow, dim re-inference, strict
op vocabulary, channel integrity, layer-tag monotonicity, dead-code warnings.

Everything :meth:`IRProgram.validate` promises is re-checked here *without*
trusting the channel table (the verifier scans send/recv nodes itself, so an
orphaned ``recv`` that ``rebuild_channels`` would drop — or raise on — still
surfaces as a diagnostic instead of an exception).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import ir as IR
from .diagnostics import Diagnostic, find_cycle

#: per-op input arity (None = any); weights/etype live in attrs after
#: construct_ir, so GEMM-class ops carry fewer inputs than their trace form
_ARITY = {}
for _op in IR.ELW_UNARY:
    _ARITY[_op] = 1
for _op in IR.ELW_BINARY:
    _ARITY[_op] = 2
_ARITY.update({"matmul": 1, "gemv": 1, "bmm_edge": 2, "output": 1,
               "input": 0, "param": 0, "const": 0})
for _op in IR.SEND_OPS:
    _ARITY[_op] = 1
for _op in IR.RECV_OPS:
    _ARITY[_op] = 0


def _check_dims(n: IR.IRNode, dims_in: List[int],
                anchor: Dict) -> List[Diagnostic]:
    """Re-infer ``n.dim`` from its input dims and attrs; report mismatches."""
    out: List[Diagnostic] = []

    def err(code: str, msg: str):
        out.append(Diagnostic(code, msg, **anchor))

    if n.op in IR.ELW_BINARY:
        a, b = dims_in
        if a != b and 1 not in (a, b):
            err("ZA004", f"{n.op}: operand dims {a} x {b} do not broadcast")
        elif n.dim != max(a, b):
            err("ZA004", f"{n.op}: declared dim {n.dim}, broadcast of "
                         f"{a} x {b} gives {max(a, b)}")
    elif n.op == "bias_add":
        wshape = n.attrs.get("wshape", ())
        if dims_in and n.dim != dims_in[0]:
            err("ZA004", f"bias_add: dim {n.dim} != input dim {dims_in[0]}")
        elif wshape and wshape[-1] not in (n.dim, 1):
            err("ZA005", f"bias_add: bias shape {wshape} incompatible with "
                         f"dim {n.dim}")
    elif n.op in IR.ELW_UNARY:
        if dims_in and n.dim != dims_in[0]:
            err("ZA004", f"{n.op}: dim {n.dim} != input dim {dims_in[0]}")
    elif n.op in ("matmul", "gemv", "bmm_edge"):
        wshape = tuple(n.attrs.get("wshape", ()))
        if len(wshape) < 2:
            err("ZA005", f"{n.op}: missing/short weight shape {wshape}")
            return out
        k, m = wshape[-2], wshape[-1]
        if dims_in and dims_in[0] != k:
            err("ZA005", f"{n.op}: contraction dim {dims_in[0]} != "
                         f"weight {wshape}[-2]={k}")
        want = 1 if n.op == "gemv" else m
        if n.dim != want:
            err("ZA005", f"{n.op}: output dim {n.dim} != {want} from "
                         f"weight {wshape}")
        if n.op == "bmm_edge" and len(dims_in) > 1 and dims_in[1] != 1:
            err("ZA005", f"bmm_edge: etype operand dim {dims_in[1]} != 1")
    elif n.op == "output" or n.is_send():
        if dims_in and n.dim != dims_in[0]:
            err("ZA004", f"{n.op}: dim {n.dim} != input dim {dims_in[0]}")
    return out


def verify_ir(prog: IR.IRProgram) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    nodes: Dict[int, IR.IRNode] = {}
    seg_label: Dict[int, str] = {}
    seg_kind: Dict[int, str] = {}
    for seg in prog.segments:
        for n in seg.nodes.values():
            if n.id in nodes:
                diags.append(Diagnostic(
                    "ZA002", f"node id %{n.id} defined in both "
                             f"{seg_label[n.id]} and {seg.label}",
                    segment=seg.label, node=n.id, origin="ir"))
            nodes[n.id] = n
            seg_label[n.id] = seg.label
            seg_kind[n.id] = seg.kind

    # --- per-node: vocabulary, arity, def-use, dims ------------------------
    for seg in prog.segments:
        for n in seg.nodes.values():
            anchor = dict(segment=seg.label, node=n.id, origin="ir")
            if n.op not in IR.ALL_OPS:
                diags.append(Diagnostic(
                    "ZA001", f"unknown op {n.op!r} (op_unit would silently "
                             f"bucket it into CTRL)", **anchor))
                continue
            want = _ARITY.get(n.op)
            if want is not None and len(n.inputs) != want:
                diags.append(Diagnostic(
                    "ZA016" if not n.is_recv() else "ZA015",
                    f"{n.op} expects {want} input(s), has {len(n.inputs)}",
                    **anchor))
                continue
            if n.is_recv() and n.inputs:
                diags.append(Diagnostic(
                    "ZA015", f"{n.op} carries intra-segment inputs "
                             f"{n.inputs}; recvs read only their channel",
                    **anchor))
            missing = [i for i in n.inputs if i not in seg.nodes]
            for i in missing:
                where = (f"defined in {seg_label[i]}" if i in nodes
                         else "undefined anywhere")
                diags.append(Diagnostic(
                    "ZA002", f"{n.op} input %{i} is not in this segment "
                             f"({where})", **anchor))
            if not missing:
                dims_in = [seg.nodes[i].dim for i in n.inputs]
                diags.extend(_check_dims(n, dims_in, anchor))
            if (n.is_send() or n.is_recv()) and n.comm_id is None:
                diags.append(Diagnostic(
                    "ZA016", f"{n.op} has no comm id", **anchor))

    # --- per-segment cycles ------------------------------------------------
    for seg in prog.segments:
        succs: Dict[int, List[int]] = {nid: [] for nid in seg.nodes}
        for n in seg.nodes.values():
            for i in n.inputs:
                if i in seg.nodes:
                    succs[i].append(n.id)
        cyc = find_cycle(succs)
        if cyc:
            chain = " -> ".join(f"%{c}" for c in cyc)
            diags.append(Diagnostic(
                "ZA003", f"dataflow cycle {chain}", segment=seg.label,
                node=cyc[0], origin="ir"))
            return diags  # downstream checks need a topological order

    # --- channels: scanned independently of rebuild_channels ---------------
    sends: Dict[int, List[int]] = {}
    recvs: Dict[int, List[int]] = {}
    for n in nodes.values():
        if n.comm_id is None:
            continue
        (sends if n.is_send() else recvs if n.is_recv() else {}) \
            .setdefault(n.comm_id, []).append(n.id)
    for cid, ids in sorted(sends.items()):
        if len(ids) > 1:
            diags.append(Diagnostic(
                "ZA011", f"comm {cid} has {len(ids)} sends: "
                         f"{['%%%d' % i for i in ids]}",
                node=ids[0], origin="ir"))
    for cid, ids in sorted(recvs.items()):
        if len(ids) > 1:
            diags.append(Diagnostic(
                "ZA011", f"comm {cid} has {len(ids)} recvs: "
                         f"{['%%%d' % i for i in ids]}",
                node=ids[0], origin="ir"))
    for cid, ids in sorted(recvs.items()):
        if cid not in sends:
            diags.append(Diagnostic(
                "ZA009", f"recv {nodes[ids[0]].op} on comm {cid} has no "
                         f"matching send",
                segment=seg_label[ids[0]], node=ids[0], origin="ir"))
    for cid, ids in sorted(sends.items()):
        if cid not in recvs:
            diags.append(Diagnostic(
                "ZA010", f"send {nodes[ids[0]].op} on comm {cid} has no "
                         f"matching recv",
                segment=seg_label[ids[0]], node=ids[0], origin="ir"))
    send_of_comm: Dict[int, int] = {}
    for cid in sorted(set(sends) & set(recvs)):
        snid, rnid = sends[cid][0], recvs[cid][0]
        send, recv = nodes[snid], nodes[rnid]
        send_of_comm[cid] = snid
        anchor = dict(segment=seg_label[rnid], node=rnid, origin="ir")
        if IR.SEND_TO_RECV.get(send.op) != recv.op:
            diags.append(Diagnostic(
                "ZA006", f"comm {cid}: {send.op} paired with {recv.op} "
                         f"(expected {IR.SEND_TO_RECV.get(send.op)})",
                **anchor))
        want = (("vertex", "edge") if send.op in ("sendOutEdge", "sendInEdge")
                else ("edge", "vertex"))
        have = (seg_kind[snid], seg_kind[rnid])
        if have != want:
            diags.append(Diagnostic(
                "ZA007", f"comm {cid}: {send.op} goes "
                         f"{have[0]}->{have[1]}, must go "
                         f"{want[0]}->{want[1]}", **anchor))
        if send.dim != recv.dim:
            diags.append(Diagnostic(
                "ZA008", f"comm {cid}: send dim {send.dim} != recv dim "
                         f"{recv.dim}", **anchor))

    # --- global dataflow: layer monotonicity, dead code, unused channels ---
    def deps(n: IR.IRNode) -> List[int]:
        if n.is_recv():
            sid = send_of_comm.get(n.comm_id)
            return [sid] if sid is not None else []
        return [i for i in n.inputs if i in nodes]

    for n in nodes.values():
        for d in deps(n):
            if nodes[d].layer > n.layer:
                diags.append(Diagnostic(
                    "ZA012", f"{n.op} (layer {n.layer}) consumes "
                             f"%{d}={nodes[d].op} of later layer "
                             f"{nodes[d].layer}",
                    segment=seg_label[n.id], node=n.id, origin="ir"))

    live = set()
    stack = [n.id for n in nodes.values() if n.op == "output"]
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        stack.extend(deps(nodes[nid]))
    consumers: Dict[int, int] = {}
    for n in nodes.values():
        for i in n.inputs:
            consumers[i] = consumers.get(i, 0) + 1
    for nid in sorted(nodes):
        n = nodes[nid]
        if n.is_recv() and consumers.get(nid, 0) == 0:
            diags.append(Diagnostic(
                "ZA014", f"{n.op} result on comm {n.comm_id} is never "
                         f"consumed", segment=seg_label[nid], node=nid,
                origin="ir"))
        elif nid not in live:
            diags.append(Diagnostic(
                "ZA013", f"{n.op} does not reach any output",
                segment=seg_label[nid], node=nid, origin="ir"))
    return diags
