"""ZIPPER ISA (paper Table 2) and SDE-function code generation.

Three instruction classes:
  * computational — ELW (VU), GEMM/BMM (MU), GOP scatter/gather (VU),
    and the fused kernel-block instructions (SPMM.TILE / SFTM.*) emitted
    when a gather block is dispatched to a Pallas hardware block
  * data-transfer — LD.SRC / LD.DST / LD.EDGE / ST.DST (memory controller)
  * synchronization — SIGNAL / WAIT / FCH.TILE / FCH.PTT / UPD.PTT / CHK.PTT

Instructions are coarse-grained: one instruction operates on all vertices or
edges of a tile (paper §6.1 "ISA").  Codegen lowers a
:class:`~repro.core.schedule.ScheduledProgram` — the SAME block structure the
JAX engines interpret — into per-(role, phase) instruction *templates*; row
counts (n_src / n_edge / partition size) are bound per tile by the scheduler
/ simulator.  A plain :class:`~repro.core.compiler.SDEPlan` is accepted for
convenience and lowered internally (``kernel_dispatch=False`` by default, the
paper's pure multi-phase schedule).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

from . import ir as IR
from .compiler import SDEPlan

#: dispatch overhead charged per instruction (decoder + operand setup), cycles
DISPATCH_CYCLES = 8

_ELW_OPCODE = {
    "add": "ELW.ADD", "sub": "ELW.SUB", "mul": "ELW.MUL", "div": "ELW.DIV",
    "max2": "ELW.MAX", "min2": "ELW.MIN", "exp": "ELW.EXP", "relu": "ELW.RELU",
    "leaky_relu": "ELW.LRELU", "sigmoid": "ELW.SIG", "tanh": "ELW.TANH",
    "neg": "ELW.NEG", "identity": "ELW.CPY", "sqrt": "ELW.SQRT",
    "rsqrt": "ELW.RSQRT", "bias_add": "ELW.ADDB",
}
_GOP_OPCODE = {
    "recvSrc": "SCTR.OUTE", "recvDst": "SCTR.INE",
    "sendDstSum": "GTHR.DST.SUM", "sendDstMax": "GTHR.DST.MAX",
    "sendDstMean": "GTHR.DST.SUM",  # mean = sum + count (extra ELW.DIV emitted)
}


@dataclasses.dataclass
class Instr:
    opcode: str
    unit: str            # 'MU' | 'VU' | 'MEM' | 'CTRL'
    rows: str = ""       # symbolic row count: 'n_src' | 'n_edge' | 'n_dst'
    k: int = 0           # inner dim (GEMM/GEMV)
    krows: str = ""      # symbolic inner dim (kernel blocks: bound per tile)
    n: int = 1           # output feature dim / ELW width
    weight_bytes: int = 0  # weight-buffer traffic (GEMM/BMM)
    fused: int = 1       # number of IR ops folded into this instruction
    tag: str = ""

    def bound(self, n_src: int, n_edge: int, n_dst: int) -> Tuple[int, int, int]:
        dims = {"n_src": n_src, "n_edge": n_edge, "n_dst": n_dst, "": 0}
        m = dims[self.rows]
        k = dims[self.krows] if self.krows else self.k
        return m, k, self.n


def _compute_instr(node: IR.IRNode, rows: str) -> Instr:
    if node.op == "matmul":
        k, n = node.attrs["wshape"][-2], node.attrs["wshape"][-1]
        return Instr("GEMM", "MU", rows, k=k, n=n, weight_bytes=4 * k * n, tag=node.op)
    if node.op == "bmm_edge":
        k, n = node.attrs["wshape"][-2], node.attrs["wshape"][-1]
        # index-guided BMM: per-row weight select defeats weight-stationarity
        return Instr("BMM", "MU", rows, k=k, n=n, weight_bytes=4 * k * n, tag=node.op)
    if node.op == "gemv":
        # matrix-vector runs on the VU (paper Table 2 lists GEMV under ELW)
        return Instr("GEMV", "VU", rows, k=node.attrs["wshape"][0], n=1, tag=node.op)
    return Instr(_ELW_OPCODE[node.op], "VU", rows, n=node.dim, tag=node.op)


def _kernel_instrs(g, layout: str = "coo") -> List[Instr]:
    """Instruction template of one Pallas-dispatched gather block.

    ``layout="coo"``: the dense tile kernels run the aggregation as an
    (n_dst × k) MXU matmul per tile instead of per-edge VU gather
    indirection — that shape shift is exactly what the simulator should
    cost.  ``layout="csr"``: the kernels walk per-tile row pointers, so the
    work is E-proportional VU gather traffic (GTHR-prefixed opcodes pick up
    the per-row indirection surcharge in ``instr_cycles``) rather than a
    dense (n_dst × n_src) matmul over mostly-empty adjacency — on
    heavy-tailed graphs the dense max-partition block is what keeps the
    kernel configs behind the scan incumbent.
    """
    from . import schedule as S

    if layout == "csr":
        if g.kernel == S.KERNEL_SPMM:
            # row-pointer walk + per-edge gather-accumulate of F-wide rows
            return [Instr("GTHR.CSR", "VU", "n_edge", n=g.acc.dim,
                          tag=g.kernel)]
        if g.kernel == S.KERNEL_SPMM_WEIGHTED:
            # no densify pass: weights ride the same per-edge walk (+1 lane
            # for the weight multiply)
            return [Instr("GTHR.CSR", "VU", "n_edge", n=g.acc.dim + 1,
                          tag=g.kernel)]
        if g.kernel == S.KERNEL_SEGMENT_SOFTMAX:
            # per-edge mask/exp/rescale, then the row-pointer-walk reduce
            return [Instr("SFTM.EDGE", "VU", "n_edge", n=3,
                          tag="online-softmax"),
                    Instr("SFTM.CSR", "VU", "n_edge", n=g.acc.dim,
                          tag=g.kernel)]
        raise ValueError(f"unknown kernel tag {g.kernel}")

    if g.kernel == S.KERNEL_SPMM:
        return [Instr("SPMM.TILE", "MU", "n_dst", krows="n_src", n=g.acc.dim,
                      tag=g.kernel)]
    if g.kernel == S.KERNEL_SPMM_WEIGHTED:
        # runtime densification of α (VU scatter) + the dense tile matmul
        return [Instr("DENS.W", "VU", "n_edge", n=1, tag="densify"),
                Instr("SPMM.TILE", "MU", "n_dst", krows="n_src", n=g.acc.dim,
                      tag=g.kernel)]
    if g.kernel == S.KERNEL_SEGMENT_SOFTMAX:
        # one online-softmax pass: per-edge mask/exp/rescale on the VU, then
        # the (n_dst × n_edge) @ (n_edge × F) probability-value matmul
        return [Instr("SFTM.EDGE", "VU", "n_edge", n=3, tag="online-softmax"),
                Instr("SFTM.MM", "MU", "n_dst", krows="n_edge", n=g.acc.dim,
                      tag=g.kernel)]
    raise ValueError(f"unknown kernel tag {g.kernel}")


@dataclasses.dataclass
class SDEFunctions:
    """Instruction templates per (role, phase-level).

    roles: 's' (source / per tile), 'e' (edge / per tile),
           'd' (destination / per partition; includes pre- and post-gather ops)
    """

    s: Dict[int, List[Instr]]
    e: Dict[int, List[Instr]]
    d: Dict[int, List[Instr]]
    src_load_dim: int   # feature width loaded per source vertex
    dst_load_dim: int   # feature width loaded per destination vertex
    edge_feat_dim: int  # per-edge input feature width (etype / efeat)
    out_dim: int        # stored output width per destination vertex
    max_level: int
    #: level -> GNN layer whose tile work runs at that level (stacked models;
    #: the stream scheduler uses this to pipeline across layer boundaries)
    level_layer: Dict[int, int] = dataclasses.field(default_factory=dict)
    n_layers: int = 1
    #: tile edge layout the templates were emitted for ("coo" | "csr") —
    #: the stream builder keys the edge-index traffic model on it
    layout: str = "coo"
    #: feature width drained at each interior layer boundary, in execution
    #: order (len == n_layers - 1); derived from the static exchange census,
    #: empty when the census is unclean (the simulator then falls back to
    #: ``max(src_load_dim, out_dim)`` for every boundary)
    boundary_dims: Tuple[int, ...] = ()

    def all_levels(self):
        return range(self.max_level + 1)

    def layer_of(self, lvl: int) -> int:
        return self.level_layer.get(lvl, 0)


def emit_sde(plan: Union[SDEPlan, "object"], fuse: bool = True,
             kernel_dispatch: bool = False, layout: str = "coo") -> SDEFunctions:
    """Lower a scheduled program into SDE instruction templates.

    Accepts either a :class:`~repro.core.schedule.ScheduledProgram` (costed
    exactly as the JAX engines execute it, kernel blocks included) or an
    :class:`SDEPlan` (lowered internally with ``kernel_dispatch``).
    ``layout`` selects the kernel-block cost templates — CSR tiles replace
    the dense per-tile matmul with E-proportional row-pointer walks (see
    :func:`_kernel_instrs`) and shrink the edge-index load traffic.
    """
    if layout not in ("coo", "csr"):
        raise ValueError(f"unknown tile layout {layout!r}")
    from . import schedule as S

    sp = (S.lower(plan, kernel_dispatch=kernel_dispatch)
          if isinstance(plan, SDEPlan) else plan)

    s: Dict[int, List[Instr]] = {}
    e: Dict[int, List[Instr]] = {}
    d: Dict[int, List[Instr]] = {}

    def _push(bucket: Dict[int, List[Instr]], lvl: int, instr: Instr):
        bucket.setdefault(lvl, []).append(instr)

    for phase in sp.phases:
        lvl = phase.level
        for node in phase.src.fresh:
            _push(s, lvl, _compute_instr(node, "n_src"))
        for node in phase.dst.fresh:
            if node.op != "output":
                _push(d, lvl, _compute_instr(node, "n_dst"))
        for node in phase.edge.fresh:
            if node.is_recv() or node.is_send():
                _push(e, lvl, Instr(_GOP_OPCODE[node.op], "VU", "n_edge",
                                    n=node.dim, tag=node.op))
                if node.op == "sendDstMean":
                    _push(d, lvl + 1, Instr("ELW.DIV", "VU", "n_dst",
                                            n=node.dim, tag="mean-div"))
            else:
                _push(e, lvl, _compute_instr(node, "n_edge"))
        for g in phase.kernel_gathers():
            for ins in _kernel_instrs(g, layout):
                _push(e, lvl, ins)

    # element-wise fusion: collapse adjacent VU ELW instrs into a single
    # instruction (saves dispatch overhead, mirrors the paper's use of
    # "existing DL optimizations" on the IR)
    if fuse:
        for bucket in (s, e, d):
            for lvl, instrs in bucket.items():
                fused: List[Instr] = []
                for ins in instrs:
                    if (fused and ins.unit == "VU" and fused[-1].unit == "VU"
                            and ins.opcode.startswith("ELW") and fused[-1].opcode.startswith("ELW")
                            and ins.rows == fused[-1].rows):
                        fused[-1] = dataclasses.replace(
                            fused[-1], fused=fused[-1].fused + 1,
                            n=fused[-1].n + ins.n,  # lane-work adds up
                            opcode="ELW.FUSED", tag=fused[-1].tag + "+" + ins.tag)
                    else:
                        fused.append(ins)
                bucket[lvl] = fused

    # per-boundary drained widths from the static exchange census: each
    # interior merged collective ships the sum of its drained nodes' dims
    # (stacks with mixed hidden widths cost each boundary its own width).
    # Import is deferred — analysis.hazards imports streams which imports
    # this module, so it must not run at isa import time.
    from .analysis.hazards import exchange_census

    census = exchange_census(sp)
    boundary_dims: Tuple[int, ...] = ()
    if census.n_collectives == sp.n_layers:
        dim_of = {n.id: n.dim for seg in sp.prog.segments
                  for n in seg.nodes.values()}
        boundary_dims = tuple(
            sum(dim_of.get(nid, 0) for nid in grp)
            for grp in census.groups[:-1])

    return SDEFunctions(s=s, e=e, d=d,
                        src_load_dim=sp.src_load_dim,
                        dst_load_dim=sp.dst_load_dim,
                        edge_feat_dim=sp.edge_feat_dim, out_dim=sp.out_dim,
                        max_level=sp.max_level,
                        level_layer=sp.layer_of_level(), n_layers=sp.n_layers,
                        layout=layout, boundary_dims=boundary_dims)
