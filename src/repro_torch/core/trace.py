"""Whole-graph tensor trace — the *classic GNN programming model*.

This is the paper's starting point (§3.3, Figure 5): a GNN is written
against tensors covering all vertices / edges at once ("DGL-like"), which
hides graph semantics.  We reproduce that programming model with a tiny
tracer: user model code manipulates :class:`TT` handles; every operation is
recorded as a :class:`TNode` in a :class:`GnnTrace`.  The compiler
(``core/compiler.py``) consumes the trace and recovers graph semantics.

Tensor *spaces*:
    'V'  — one row per vertex            (shape [n_vertices, dim])
    'E'  — one row per edge              (shape [n_edges, dim])
    'P'  — parameter (shared weights)    (shape attrs['shape'])
Only GOPs (scatter / gather) change the space of a tensor — this property is
what lets the compiler split the program into vertex/edge segments.

Multi-layer programs: ZIPPER's evaluation stacks layers (§8.1), so a trace
may span several GNN layers.  :func:`trace_model` accepts either one build
function or a *sequence of layer builders* ``fn(tr, g, x) -> TT`` — layer
``l``'s output tensor becomes layer ``l+1``'s input — and every emitted node
is tagged with the layer that produced it (``GnnTrace.layer_of``), which the
compiler propagates through the IR into the scheduled phase program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import ir as IR


@dataclasses.dataclass
class TNode:
    id: int
    op: str
    space: str  # 'V' | 'E' | 'P'
    inputs: List[int]
    attrs: Dict[str, Any]
    dim: int


class GnnTrace:
    """Recorded whole-graph computation."""

    def __init__(self, name: str = "gnn"):
        self.name = name
        self.nodes: List[TNode] = []
        self.inputs: List[int] = []   # node ids of graph inputs (vertex/edge feats)
        self.outputs: List[int] = []  # node ids of model outputs
        self.params: Dict[str, Tuple[int, ...]] = {}  # name -> shape
        self.layer_of: Dict[int, int] = {}  # node id -> GNN layer that emitted it
        self._layer = 0

    def begin_layer(self, layer: int) -> None:
        """Tag subsequently emitted nodes as belonging to GNN layer ``layer``."""
        self._layer = int(layer)

    @property
    def n_layers(self) -> int:
        return max(self.layer_of.values(), default=0) + 1

    def emit(self, op: str, space: str, inputs: Sequence[int], dim: int, **attrs) -> "TT":
        node = TNode(id=len(self.nodes), op=op, space=space,
                     inputs=list(inputs), attrs=dict(attrs), dim=dim)
        self.nodes.append(node)
        self.layer_of[node.id] = self._layer
        return TT(self, node.id)

    def node(self, nid: int) -> TNode:
        return self.nodes[nid]

    # -- user-facing declaration helpers --------------------------------------
    def input_vertex(self, dim: int, name: str = "x") -> "TT":
        t = self.emit("input", "V", [], dim, name=name)
        self.inputs.append(t.nid)
        return t

    def input_edge(self, dim: int, name: str = "efeat") -> "TT":
        t = self.emit("input", "E", [], dim, name=name)
        self.inputs.append(t.nid)
        return t

    def param(self, name: str, shape: Tuple[int, ...]) -> "TT":
        self.params[name] = tuple(shape)
        return self.emit("param", "P", [], shape[-1], name=name, shape=tuple(shape))

    def mark_output(self, t: "TT") -> None:
        out = self.emit("output", t.space, [t.nid], t.dim)
        self.outputs.append(out.nid)


class TT:
    """Traced tensor handle (whole-graph semantics)."""

    def __init__(self, trace: GnnTrace, nid: int):
        self.trace = trace
        self.nid = nid

    # -- bookkeeping -----------------------------------------------------------
    @property
    def node(self) -> TNode:
        return self.trace.node(self.nid)

    @property
    def space(self) -> str:
        return self.node.space

    @property
    def dim(self) -> int:
        return self.node.dim

    # -- NN ops (GEMM class) ----------------------------------------------------
    def matmul(self, w: "TT") -> "TT":
        """x @ W  — per-item dense transform. W: (dim_in, dim_out)."""
        shape = w.node.attrs["shape"]
        assert shape[0] == self.dim, f"matmul dim mismatch {shape} vs {self.dim}"
        return self.trace.emit("matmul", self.space, [self.nid, w.nid], shape[-1])

    def gemv(self, a: "TT") -> "TT":
        """x @ a  — per-item mat-vec producing a scalar per item. a: (dim_in, 1)."""
        shape = a.node.attrs["shape"]
        assert shape[0] == self.dim and shape[-1] == 1
        return self.trace.emit("gemv", self.space, [self.nid, a.nid], 1)

    def bmm_edge(self, w: "TT", etype: "TT") -> "TT":
        """Edge-type-guided batched matmul (R-GCN): out_e = x_e @ W[etype_e].

        W: (n_types, dim_in, dim_out); etype: per-edge integer type ('E', dim=1).
        """
        shape = w.node.attrs["shape"]
        assert self.space == "E" and etype.space == "E"
        assert shape[1] == self.dim
        return self.trace.emit("bmm_edge", "E", [self.nid, w.nid, etype.nid], shape[-1])

    # -- element-wise ops --------------------------------------------------------
    def _elw2(self, op: str, other: "TT") -> "TT":
        assert self.space == other.space, f"{op}: space mismatch {self.space} vs {other.space}"
        dim = max(self.dim, other.dim)  # (N,1) broadcasting allowed
        return self.trace.emit(op, self.space, [self.nid, other.nid], dim)

    def __add__(self, other: "TT") -> "TT":
        return self._elw2("add", other)

    def __sub__(self, other: "TT") -> "TT":
        return self._elw2("sub", other)

    def __mul__(self, other: "TT") -> "TT":
        return self._elw2("mul", other)

    def __truediv__(self, other: "TT") -> "TT":
        return self._elw2("div", other)

    def max2(self, other: "TT") -> "TT":
        return self._elw2("max2", other)

    def _elw1(self, op: str, **attrs) -> "TT":
        return self.trace.emit(op, self.space, [self.nid], self.dim, **attrs)

    def bias_add(self, b: "TT") -> "TT":
        """x + b where b is a (dim,) parameter."""
        shape = b.node.attrs["shape"]
        assert shape[-1] in (self.dim, 1)
        return self.trace.emit("bias_add", self.space, [self.nid, b.nid], self.dim)

    def relu(self) -> "TT":
        return self._elw1("relu")

    def leaky_relu(self, slope: float = 0.2) -> "TT":
        return self._elw1("leaky_relu", slope=slope)

    def exp(self) -> "TT":
        return self._elw1("exp")

    def sigmoid(self) -> "TT":
        return self._elw1("sigmoid")

    def tanh(self) -> "TT":
        return self._elw1("tanh")


class GraphRef:
    """Handle for GOPs on the (symbolic) input graph."""

    def __init__(self, trace: GnnTrace):
        self.trace = trace

    # scatter: vertex -> edge
    def scatter_src(self, x: TT) -> TT:
        """Copy each source vertex's embedding onto its out-edges."""
        assert x.space == "V"
        return self.trace.emit("scatter_src", "E", [x.nid], x.dim)

    def scatter_dst(self, x: TT) -> TT:
        """Copy each destination vertex's embedding onto its in-edges."""
        assert x.space == "V"
        return self.trace.emit("scatter_dst", "E", [x.nid], x.dim)

    # gather: edge -> vertex (with reduce)
    def gather(self, e: TT, reduce: str = "sum") -> TT:
        assert e.space == "E" and reduce in ("sum", "max", "mean")
        return self.trace.emit("gather", "V", [e.nid], e.dim, reduce=reduce)

    def gather_sum(self, e: TT) -> TT:
        return self.gather(e, "sum")

    def gather_max(self, e: TT) -> TT:
        return self.gather(e, "max")

    def gather_mean(self, e: TT) -> TT:
        return self.gather(e, "mean")

    # composite: numerically-stable edge softmax over in-edges of each dst
    def edge_softmax(self, e: TT) -> TT:
        m = self.gather_max(e)          # V: per-dst max
        shifted = e - self.scatter_dst(m)
        ex = shifted.exp()
        s = self.gather_sum(ex)         # V: per-dst sum
        return ex / self.scatter_dst(s)


GOP_TRACE_OPS = ("scatter_src", "scatter_dst", "gather")


def trace_model(build_fn, name: str = "gnn") -> GnnTrace:
    """Trace a whole-graph model and return the completed trace.

    ``build_fn`` is either

    * one function ``build_fn(trace, graph_ref)`` that declares inputs /
      params and marks outputs itself (the classic single-layer form), or
    * a *sequence of layer builders* ``fn(trace, graph_ref, x) -> TT``:
      layer ``l`` receives layer ``l-1``'s output tensor as ``x`` (``None``
      for the first layer, which declares the graph inputs), returns its own
      output tensor, and the final layer's output is marked automatically.
      Nodes are layer-tagged via :meth:`GnnTrace.begin_layer`.
    """
    tr = GnnTrace(name=name)
    g = GraphRef(tr)
    if callable(build_fn):
        build_fn(tr, g)
    else:
        if not build_fn:
            raise ValueError("trace_model got an empty layer-builder sequence")
        x: Optional[TT] = None
        for layer, fn in enumerate(build_fn):
            tr.begin_layer(layer)
            x = fn(tr, g, x)
            if x is None:
                raise ValueError(f"layer builder {layer} returned no tensor")
        tr.mark_output(x)  # output indicator stays tagged with the last layer
    if not tr.outputs:
        raise ValueError("model marked no outputs")
    return tr
