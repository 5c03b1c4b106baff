"""The paper's five benchmark GNN models (§8.1), written against the classic
whole-graph programming model.

GCN, GAT (1 head, as in the paper), GraphSAGE (maxpool aggregator), GGNN
(GRU update), R-GCN (3 edge types, as in the paper).  For GAT and SAGE we
also provide the *naive* variants the paper uses to evaluate the compiler's
E2V optimization (Fig 12): per-edge ops that a library author would normally
hand-hoist are left on the edges, and the compiler must hoist them.

Every model is written as a reusable **layer function** ``layer_X(tr, g, x,
out_dim, prefix=...) -> TT`` plus a thin single-layer ``build_X`` wrapper.
:func:`build_stacked` chains layer functions into the stacked variants the
paper evaluates (§8.1 runs multi-layer GCN/GAT/SAGE/GGNN/R-GCN): layer
``l``'s output tensor becomes layer ``l+1``'s input, parameters are
per-layer (``l{l}.`` prefix), and structure-only inputs (``dnorm``,
``etype``) are declared once and shared — the compiler's cross-layer
redundancy pass deduplicates the per-layer re-scatters they induce.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.trace import GnnTrace, GraphRef, TT, trace_model
from .graphs import Graph

EMBED = 128  # the paper's input/output embedding size for all experiments


# ---------------------------------------------------------------------------
# layer functions (trace-time, stackable)
# ---------------------------------------------------------------------------

def layer_gcn(tr: GnnTrace, g: GraphRef, x: TT, out_dim: int, *,
              dnorm: TT, prefix: str = "", edge_norm: bool = False) -> TT:
    """GCN layer: relu(D^-1/2 A D^-1/2 X W)  — norm via precomputed dnorm.

    ``edge_norm=True`` applies the symmetric normalization per edge
    (``scatter_src(dn) * scatter_dst(dn)``, the textbook stacked form):
    numerically identical, but the normalized-adjacency scatters depend only
    on graph structure, so in a stacked model every layer re-emits them and
    the compiler's cross-layer CSE pass must deduplicate.
    """
    w = tr.param(prefix + "W", (x.dim, out_dim))
    if edge_norm:
        h = x.matmul(w)
        escale = g.scatter_src(dnorm) * g.scatter_dst(dnorm)
        agg = g.gather_sum(g.scatter_src(h) * escale)
        return agg.relu()
    h = (x * dnorm).matmul(w)
    agg = g.gather_sum(g.scatter_src(h))
    return (agg * dnorm).relu()


def layer_gat(tr: GnnTrace, g: GraphRef, x: TT, out_dim: int, *,
              prefix: str = "", naive: bool = False) -> TT:
    """GAT layer, single head (paper §8.1). ``naive=True`` leaves the two
    attention mat-vecs on the edges — the compiler's E2V pass must hoist them
    (paper Fig 8b / Fig 12)."""
    w = tr.param(prefix + "W", (x.dim, out_dim))
    a1 = tr.param(prefix + "a_src", (out_dim, 1))
    a2 = tr.param(prefix + "a_dst", (out_dim, 1))
    h = x.matmul(w)
    if naive:
        hs = g.scatter_src(h)
        hd = g.scatter_dst(h)
        e = (hs.gemv(a1) + hd.gemv(a2)).leaky_relu()
    else:
        es = g.scatter_src(h.gemv(a1))
        ed = g.scatter_dst(h.gemv(a2))
        e = (es + ed).leaky_relu()
    alpha = g.edge_softmax(e)
    m = g.scatter_src(h) * alpha
    return g.gather_sum(m)


def layer_sage(tr: GnnTrace, g: GraphRef, x: TT, out_dim: int, *,
               prefix: str = "", naive: bool = False) -> TT:
    """GraphSAGE-maxpool: h_N = max_j relu(W_p x_j + b); out = relu(W1 x + W2 h_N)."""
    in_dim = x.dim
    wp = tr.param(prefix + "W_pool", (in_dim, out_dim))
    bp = tr.param(prefix + "b_pool", (out_dim,))
    w1 = tr.param(prefix + "W_self", (in_dim, out_dim))
    w2 = tr.param(prefix + "W_neigh", (out_dim, out_dim))
    if naive:
        # pooling MLP applied per edge (redundant): E2V must hoist it
        xs = g.scatter_src(x)
        pe = xs.matmul(wp).bias_add(bp).relu()
    else:
        pv = x.matmul(wp).bias_add(bp).relu()
        pe = g.scatter_src(pv)
    hn = g.gather_max(pe)
    return (x.matmul(w1) + hn.matmul(w2)).relu()


def layer_ggnn(tr: GnnTrace, g: GraphRef, x: TT, out_dim: Optional[int] = None, *,
               prefix: str = "") -> TT:
    """GGNN: a = A(X W_msg); h' = GRU(a, x) — GRU from separate ELW+GEMM ops
    (the paper implements the GRU with separate instructions on ZIPPER).
    The GRU state keeps the input width; a differing ``out_dim`` is an error,
    not a silent no-op."""
    d = x.dim
    if out_dim is not None and out_dim != d:
        raise ValueError(f"GGNN preserves the feature dim ({d}); "
                         f"got out_dim={out_dim}")
    wm = tr.param(prefix + "W_msg", (d, d))
    wz, uz = tr.param(prefix + "W_z", (d, d)), tr.param(prefix + "U_z", (d, d))
    wr, ur = tr.param(prefix + "W_r", (d, d)), tr.param(prefix + "U_r", (d, d))
    wh, uh = tr.param(prefix + "W_h", (d, d)), tr.param(prefix + "U_h", (d, d))
    a = g.gather_sum(g.scatter_src(x.matmul(wm)))
    z = (a.matmul(wz) + x.matmul(uz)).sigmoid()
    r = (a.matmul(wr) + x.matmul(ur)).sigmoid()
    hh = (a.matmul(wh) + (r * x).matmul(uh)).tanh()
    # h' = (1-z)*x + z*hh  ==  x + z*(hh - x)
    return x + z * (hh - x)


def layer_rgcn(tr: GnnTrace, g: GraphRef, x: TT, out_dim: int, *,
               etype: TT, prefix: str = "", n_types: int = 3) -> TT:
    """R-GCN with 3 randomly-assigned edge types (paper §8.1): per-edge
    type-selected weights — an index-guided BMM that canNOT be hoisted."""
    wr = tr.param(prefix + "W_rel", (n_types, x.dim, out_dim))
    w0 = tr.param(prefix + "W_self", (x.dim, out_dim))
    xs = g.scatter_src(x)
    m = xs.bmm_edge(wr, etype)
    h = g.gather_sum(m)
    return (h + x.matmul(w0)).relu()


def layer_gin(tr: GnnTrace, g: GraphRef, x: TT, out_dim: int, *,
              prefix: str = "") -> TT:
    """GIN (Xu et al.): h' = MLP((1+eps)·x + sum_j x_j) — beyond the paper's
    five models, exercising the generality claim (sum-agg + vertex MLP)."""
    in_dim = x.dim
    w1 = tr.param(prefix + "W1", (in_dim, out_dim))
    b1 = tr.param(prefix + "b1", (out_dim,))
    w2 = tr.param(prefix + "W2", (out_dim, out_dim))
    eps = tr.param(prefix + "eps_gain", (in_dim, in_dim))  # (1+eps)·x as a learned diag-ish map
    agg = g.gather_sum(g.scatter_src(x))
    h = agg + x.matmul(eps)
    return h.matmul(w1).bias_add(b1).relu().matmul(w2)


# ---------------------------------------------------------------------------
# single-layer builders (classic form; same traces as before the refactor)
# ---------------------------------------------------------------------------

def build_gcn(tr: GnnTrace, g: GraphRef, in_dim: int = EMBED, out_dim: int = EMBED):
    x = tr.input_vertex(in_dim, "x")
    dn = tr.input_vertex(1, "dnorm")  # (V,1): 1/sqrt(max(deg,1))
    tr.mark_output(layer_gcn(tr, g, x, out_dim, dnorm=dn))


def build_gat(tr: GnnTrace, g: GraphRef, in_dim: int = EMBED, out_dim: int = EMBED,
              naive: bool = False):
    x = tr.input_vertex(in_dim, "x")
    tr.mark_output(layer_gat(tr, g, x, out_dim, naive=naive))


def build_gat_naive(tr, g, in_dim: int = EMBED, out_dim: int = EMBED):
    return build_gat(tr, g, in_dim, out_dim, naive=True)


def build_sage(tr: GnnTrace, g: GraphRef, in_dim: int = EMBED, out_dim: int = EMBED,
               naive: bool = False):
    x = tr.input_vertex(in_dim, "x")
    tr.mark_output(layer_sage(tr, g, x, out_dim, naive=naive))


def build_sage_naive(tr, g, in_dim: int = EMBED, out_dim: int = EMBED):
    return build_sage(tr, g, in_dim, out_dim, naive=True)


def build_ggnn(tr: GnnTrace, g: GraphRef, in_dim: int = EMBED, out_dim: Optional[int] = None):
    x = tr.input_vertex(in_dim, "x")
    tr.mark_output(layer_ggnn(tr, g, x, out_dim))


def build_rgcn(tr: GnnTrace, g: GraphRef, in_dim: int = EMBED, out_dim: int = EMBED,
               n_types: int = 3):
    x = tr.input_vertex(in_dim, "x")
    et = tr.input_edge(1, "etype")
    tr.mark_output(layer_rgcn(tr, g, x, out_dim, etype=et, n_types=n_types))


def build_gin(tr: GnnTrace, g: GraphRef, in_dim: int = EMBED, out_dim: int = EMBED):
    x = tr.input_vertex(in_dim, "x")
    tr.mark_output(layer_gin(tr, g, x, out_dim))


@dataclasses.dataclass
class ModelSpec:
    name: str
    build: Callable
    layer: Optional[Callable] = None     # stackable layer fn (None: 1-layer only)
    needs_etype: bool = False
    needs_dnorm: bool = False
    n_edge_types: int = 3
    #: extra kwargs the stacked variant passes to ``layer`` (e.g. GCN's
    #: per-edge normalization, whose structure-only scatters repeat per layer)
    stacked_kw: Dict = dataclasses.field(default_factory=dict)


MODELS: Dict[str, ModelSpec] = {
    "gcn": ModelSpec("gcn", build_gcn, layer_gcn, needs_dnorm=True,
                     stacked_kw={"edge_norm": True}),
    "gat": ModelSpec("gat", build_gat, layer_gat),
    "gat_naive": ModelSpec("gat_naive", build_gat_naive, None),
    "sage": ModelSpec("sage", build_sage, layer_sage),
    "sage_naive": ModelSpec("sage_naive", build_sage_naive, None),
    "ggnn": ModelSpec("ggnn", build_ggnn, layer_ggnn),
    "rgcn": ModelSpec("rgcn", build_rgcn, layer_rgcn, needs_etype=True),
    "gin": ModelSpec("gin", build_gin, layer_gin),
}

PAPER_MODELS = ("gcn", "gat", "sage", "ggnn", "rgcn")


def trace_named(name: str, in_dim: int = EMBED, out_dim: int = EMBED) -> GnnTrace:
    spec = MODELS[name]
    return trace_model(lambda tr, g: spec.build(tr, g, in_dim, out_dim), name=name)


# ---------------------------------------------------------------------------
# stacked (multi-layer) variants — the paper's §8.1 evaluation models
# ---------------------------------------------------------------------------

def build_stacked(name: str, n_layers: int, in_dim: int = EMBED,
                  hidden_dim: int = EMBED, out_dim: int = EMBED) -> List[Callable]:
    """Per-layer builders for a stacked ``name`` model, consumable by
    :func:`~repro.core.trace.trace_model`.

    Layer ``l`` receives layer ``l-1``'s output tensor; parameters get an
    ``l{l}.`` prefix (per-layer weights); structure-only inputs (``dnorm``,
    ``etype``) are declared by the first layer and shared by all of them.
    """
    spec = MODELS[name]
    if spec.layer is None:
        raise ValueError(f"model {name!r} has no stackable layer function")
    if n_layers < 1:
        raise ValueError("n_layers must be >= 1")
    shared: Dict[int, Dict[str, TT]] = {}  # per-trace shared structure inputs

    def make(layer_idx: int) -> Callable:
        def build(tr: GnnTrace, g: GraphRef, x: Optional[TT]) -> TT:
            if layer_idx == 0:
                shared.clear()   # only the trace being built is ever needed
            if x is None:
                x = tr.input_vertex(in_dim, "x")
            sh = shared.setdefault(id(tr), {})
            if spec.needs_dnorm and "dnorm" not in sh:
                sh["dnorm"] = tr.input_vertex(1, "dnorm")
            if spec.needs_etype and "etype" not in sh:
                sh["etype"] = tr.input_edge(1, "etype")
            d_out = out_dim if layer_idx == n_layers - 1 else hidden_dim
            return spec.layer(tr, g, x, d_out, prefix=f"l{layer_idx}.",
                              **sh, **spec.stacked_kw)
        return build

    return [make(layer) for layer in range(n_layers)]


def trace_stacked(name: str, n_layers: int, in_dim: int = EMBED,
                  hidden_dim: int = EMBED, out_dim: int = EMBED) -> GnnTrace:
    """Trace an ``n_layers``-deep stack of ``name`` layers (one program)."""
    return trace_model(
        build_stacked(name, n_layers, in_dim, hidden_dim, out_dim),
        name=f"{name}_x{n_layers}")


# ---------------------------------------------------------------------------
# parameter / input initialization
# ---------------------------------------------------------------------------

def init_params(tr: GnnTrace, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in tr.params.items():
        fan_in = shape[0] if len(shape) > 1 else 1
        params[name] = (rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)
    return params


def init_inputs(tr: GnnTrace, graph: Graph, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed + 1)
    inputs: Dict[str, np.ndarray] = {}
    for n in tr.nodes:
        if n.op != "input":
            continue
        name = n.attrs["name"]
        if name == "dnorm":
            deg = graph.in_degrees().astype(np.float32)
            inputs[name] = (1.0 / np.sqrt(np.maximum(deg, 1.0)))[:, None]
        elif name == "etype":
            assert graph.edge_type is not None, "graph has no edge types"
            inputs[name] = graph.edge_type[:, None].astype(np.float32)
        elif n.space == "V":
            inputs[name] = rng.standard_normal((graph.n_vertices, n.dim)).astype(np.float32)
        else:
            inputs[name] = rng.standard_normal((graph.n_edges, n.dim)).astype(np.float32)
    return inputs
