"""R-GCN as published (Schlichtkrull et al., "Modeling Relational Data with
Graph Convolutional Networks", ESWC 2018, eqs. 2-3), on the port's
whole-graph path.

A layer:

    h_i' = relu( sum_r sum_{j in N_i^r} (1 / c_{i,r}) W_r h_j + W_0 h_i )

with ``c_{i,r} = |N_i^r|``, the in-neighbours of ``i`` under relation
``r``, and the basis decomposition ``W_r = sum_b a_{rb} V_b``.  The
relations hold each of the graph's relations in its canonical direction and
as an inverse: an edge ``j -> i`` of relation ``r`` also gives ``i -> j``
of relation ``r + R/2`` (:func:`add_inverse_edges`).

``models.layer_rgcn`` is ZIPPER's simplification (3 random types, no
normalisation, no bases) and stays as it is.  The layer here is written
with the trace ops the IR has: the normalisation is the edge input
``enorm`` (E, 1) = 1 / c_{i,r}, the relation weights the parameter
``W_rel`` (R, F_in, F_out) of ``bmm_edge``.  The published parameters are
the bases ``V`` (B, F_in, F_out) and coefficients ``a`` (R, B) of each
layer and its ``W_self``; :func:`combine_bases` turns them into the
program's ``W_rel`` on the card, one matmul a layer, inside every pass
(:func:`run`).  While the recorder (:mod:`repro_torch.spans`) is on, the
combination is the span ``rgcn.basis``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import spans
from ..core.trace import GnnTrace, GraphRef, TT, trace_model
from .graphs import Graph


def layer_rgcn_basis(tr: GnnTrace, g: GraphRef, x: TT, out_dim: int, *,
                     etype: TT, enorm: TT, n_relations: int,
                     prefix: str = "") -> TT:
    """One published R-GCN layer over ``n_relations`` relations (inverses
    included): per-edge ``(1 / c_{i,r}) W_r h_j`` summed at ``i``, plus the
    self-connection ``W_0 h_i``, then ReLU."""
    wr = tr.param(prefix + "W_rel", (n_relations, x.dim, out_dim))
    w0 = tr.param(prefix + "W_self", (x.dim, out_dim))
    m = g.scatter_src(x).bmm_edge(wr, etype) * enorm
    return (g.gather_sum(m) + x.matmul(w0)).relu()


def trace_rgcn(n_layers: int, in_dim: int, hidden_dim: int, out_dim: int,
               n_relations: int) -> GnnTrace:
    """An ``n_layers``-deep stack; inputs ``x`` (V, in_dim) and the edge
    inputs ``etype`` and ``enorm`` (E, 1), shared by every layer."""
    if n_layers < 1:
        raise ValueError("n_layers must be >= 1")
    edge_inputs: Dict[str, TT] = {}

    def make(layer: int):
        def build(tr: GnnTrace, g: GraphRef, x):
            if x is None:
                x = tr.input_vertex(in_dim, "x")
                edge_inputs["etype"] = tr.input_edge(1, "etype")
                edge_inputs["enorm"] = tr.input_edge(1, "enorm")
            d_out = out_dim if layer == n_layers - 1 else hidden_dim
            return layer_rgcn_basis(tr, g, x, d_out, n_relations=n_relations,
                                    prefix=f"l{layer}.", **edge_inputs)
        return build

    return trace_model([make(layer) for layer in range(n_layers)],
                       name=f"rgcn_basis_x{n_layers}")


def basis_shapes(n_layers: int, in_dim: int, hidden_dim: int, out_dim: int,
                 n_relations: int, n_bases: int) -> Dict[str, Tuple[int, ...]]:
    """The published parameters: per layer ``V`` (B, F_in, F_out), ``a``
    (R, B) and ``W_self`` (F_in, F_out)."""
    dims = [in_dim] + [hidden_dim] * (n_layers - 1) + [out_dim]
    out: Dict[str, Tuple[int, ...]] = {}
    for i in range(n_layers):
        out[f"l{i}.V"] = (n_bases, dims[i], dims[i + 1])
        out[f"l{i}.a"] = (n_relations, n_bases)
        out[f"l{i}.W_self"] = (dims[i], dims[i + 1])
    return out


def combine_bases(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The program's parameters from the published ones: each layer's
    ``W_rel = a V`` as one (R, B) x (B, F_in F_out) matmul, and ``W_self``
    as given."""
    with spans.span("rgcn.basis"):
        out = {}
        for name, t in params.items():
            if name.endswith(".a"):
                p = name[:-1]
                v = params[p + "V"]
                out[p + "W_rel"] = (t @ v.reshape(v.shape[0], -1)).reshape(
                    t.shape[0], *v.shape[1:])
            elif not name.endswith(".V"):
                out[name] = t
        return out


def run(runner, inputs: Dict, params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """One pass of a runner built on :func:`trace_rgcn`'s program: the
    basis combination, then the tiled program."""
    return runner(inputs, combine_bases(params))


def add_inverse_edges(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                      n_relations: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The edges with their inverses: ``(src, dst, etype)`` of 2 E edges,
    the given ones first (types ``rel``, in [0, R/2)), then each reversed
    with type ``rel + R/2``.  ``n_relations`` is R, inverses included."""
    if n_relations % 2:
        raise ValueError(f"n_relations ({n_relations}) counts each relation "
                         "and its inverse, so it is even")
    half = n_relations // 2
    rel = np.asarray(rel)
    if len(rel) and (rel.min() < 0 or rel.max() >= half):
        raise ValueError(f"relation types must lie in [0, {half})")
    return (np.concatenate([src, dst]).astype(np.int32),
            np.concatenate([dst, src]).astype(np.int32),
            np.concatenate([rel, rel + half]).astype(np.int32))


def relation_norm(dst: np.ndarray, etype: np.ndarray, n_relations: int) -> np.ndarray:
    """(E,) float32: 1 / c_{i,r} of each edge, the count of edges that
    share its destination ``i`` and its relation ``r``."""
    key = dst.astype(np.int64) * n_relations + etype
    _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    return (1.0 / counts[inverse.reshape(-1)]).astype(np.float32)


def relational_graph(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                     n_vertices: int, n_relations: int,
                     name: str = "relational") -> Tuple[Graph, Dict[str, np.ndarray]]:
    """The graph with inverse edges, and the edge inputs of
    :func:`trace_rgcn`'s program: ``etype`` and ``enorm`` (E, 1) float32."""
    s, d, et = add_inverse_edges(src, dst, rel, n_relations)
    g = Graph(src=s, dst=d, n_vertices=n_vertices, edge_type=et, name=name)
    return g, {"etype": et[:, None].astype(np.float32),
               "enorm": relation_norm(d, et, n_relations)[:, None]}
