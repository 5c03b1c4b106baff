"""Graph data substrate: COO graphs, degree utilities, synthetic generators.

The paper evaluates on six public graphs (Table 3).  This container has no
dataset downloads, so we provide *generators* that reproduce each dataset's
vertex/edge counts and degree skew (power-law for social/collab networks,
near-uniform for road networks).  ``paper_graph(name, scale=...)`` yields a
structurally-matched synthetic stand-in; `scale` shrinks it for CPU runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed graph in COO. Edge e: src[e] -> dst[e]."""

    src: np.ndarray  # int32 (E,)
    dst: np.ndarray  # int32 (E,)
    n_vertices: int
    edge_type: Optional[np.ndarray] = None  # int32 (E,) for R-GCN
    name: str = "graph"

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_vertices).astype(np.int32)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices).astype(np.int32)

    def validate(self) -> None:
        assert self.src.shape == self.dst.shape
        assert self.src.min(initial=0) >= 0 and (
            self.n_edges == 0 or self.src.max() < self.n_vertices)
        assert self.dst.min(initial=0) >= 0 and (
            self.n_edges == 0 or self.dst.max() < self.n_vertices)

    def sorted_by_dst(self) -> "Graph":
        order = np.lexsort((self.src, self.dst))
        return Graph(src=self.src[order], dst=self.dst[order], n_vertices=self.n_vertices,
                     edge_type=None if self.edge_type is None else self.edge_type[order],
                     name=self.name)


# ---------------------------------------------------------------------------
# multi-graph batching (serving substrate)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GraphBatch:
    """Block-diagonal merge of many small graphs into one super-graph.

    One ScheduledProgram execution over ``graph`` serves every member graph
    at once: vertex ids of graph ``i`` are shifted by ``vertex_offsets[i]``,
    edge rows by ``edge_offsets[i]``, and no cross-graph edges exist, so
    per-member results are exact slices of the merged result.
    """

    graph: Graph
    vertex_offsets: np.ndarray   # int64 (G+1,) — member i owns [o[i], o[i+1])
    edge_offsets: np.ndarray     # int64 (G+1,)
    graph_ids: np.ndarray        # int32 (V,) — member index of each vertex

    @property
    def n_graphs(self) -> int:
        return len(self.vertex_offsets) - 1

    def unbatch_vertex(self, arr) -> List[np.ndarray]:
        """Split a merged (V, d) vertex array back into per-graph arrays."""
        arr = np.asarray(arr)
        o = self.vertex_offsets
        return [arr[o[i]:o[i + 1]] for i in range(self.n_graphs)]

    def unbatch_edge(self, arr) -> List[np.ndarray]:
        """Split a merged (E, d) edge array back into per-graph arrays."""
        arr = np.asarray(arr)
        o = self.edge_offsets
        return [arr[o[i]:o[i + 1]] for i in range(self.n_graphs)]

    def graph_pool(self, arr, reduce: str = "mean") -> np.ndarray:
        """Per-graph readout of a merged (V, d) vertex array -> (G, d).
        Accepts class-padded arrays (rows beyond the real vertices ignored).
        """
        arr = np.asarray(arr)
        V = len(self.graph_ids)
        if arr.shape[0] < V:
            raise ValueError(f"vertex array has {arr.shape[0]} rows, "
                             f"expected >= {V}")
        arr = arr[:V]
        G = self.n_graphs
        out = np.zeros((G,) + arr.shape[1:], np.float64)
        np.add.at(out, self.graph_ids, arr)
        if reduce == "mean":
            sizes = np.diff(self.vertex_offsets).astype(np.float64)
            out /= np.maximum(sizes, 1.0)[:, None]
            # means of integer features are fractional — stay floating
            return out.astype(np.result_type(arr.dtype, np.float32))
        if reduce != "sum":
            raise ValueError(reduce)
        return out.astype(arr.dtype)


def batch_graphs(graphs: Sequence[Graph], name: str = "batch") -> GraphBatch:
    """Merge ``graphs`` into one block-diagonal super-graph (DGL/PyG-style).

    Edge indices are offset per member; ``edge_type`` is concatenated when
    every member carries it (mixing typed and untyped members is an error).
    """
    if not graphs:
        raise ValueError("batch_graphs needs at least one graph")
    vo = np.zeros(len(graphs) + 1, np.int64)
    eo = np.zeros(len(graphs) + 1, np.int64)
    for i, g in enumerate(graphs):
        vo[i + 1] = vo[i] + g.n_vertices
        eo[i + 1] = eo[i] + g.n_edges
    src = np.concatenate([g.src.astype(np.int64) + vo[i]
                          for i, g in enumerate(graphs)]).astype(np.int32)
    dst = np.concatenate([g.dst.astype(np.int64) + vo[i]
                          for i, g in enumerate(graphs)]).astype(np.int32)
    typed = [g.edge_type is not None for g in graphs]
    if any(typed) and not all(typed):
        raise ValueError("cannot batch typed and untyped graphs together")
    etype = (np.concatenate([g.edge_type for g in graphs]).astype(np.int32)
             if all(typed) else None)
    gids = np.concatenate([np.full(g.n_vertices, i, np.int32)
                           for i, g in enumerate(graphs)])
    merged = Graph(src=src, dst=dst, n_vertices=int(vo[-1]), edge_type=etype,
                   name=name)
    merged.validate()
    return GraphBatch(graph=merged, vertex_offsets=vo, edge_offsets=eo,
                      graph_ids=gids)


def pad_graph(graph: Graph, n_vertices: int) -> Graph:
    """Grow the vertex set to ``n_vertices`` with edge-less padding vertices.

    Padding vertices receive no messages and send none, so real-vertex
    results are unchanged; the serving layer uses this to snap a merged
    request batch onto a shared size class (one compiled program per class).
    """
    if n_vertices < graph.n_vertices:
        raise ValueError(f"cannot shrink graph {graph.n_vertices} -> {n_vertices}")
    if n_vertices == graph.n_vertices:
        return graph
    return Graph(src=graph.src, dst=graph.dst, n_vertices=n_vertices,
                 edge_type=graph.edge_type, name=graph.name)


def random_graph(n_vertices: int, n_edges: int, seed: int = 0,
                 model: str = "powerlaw", n_edge_types: Optional[int] = None,
                 name: str = "synthetic") -> Graph:
    """Synthetic digraph. ``powerlaw``: zipf-skewed endpoints (social-like);
    ``uniform``: iid endpoints (road-network-like)."""
    rng = np.random.default_rng(seed)
    if model == "powerlaw":
        # sample endpoints with probability ∝ rank^{-0.9} (heavy-tailed)
        ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
        probs = ranks ** -0.9
        probs /= probs.sum()
        src = rng.choice(n_vertices, size=n_edges, p=probs).astype(np.int32)
        dst = rng.choice(n_vertices, size=n_edges, p=probs).astype(np.int32)
        # shuffle vertex ids so high-degree vertices are NOT pre-sorted
        perm = rng.permutation(n_vertices).astype(np.int32)
        src, dst = perm[src], perm[dst]
    elif model == "uniform":
        src = rng.integers(0, n_vertices, size=n_edges, dtype=np.int32)
        dst = rng.integers(0, n_vertices, size=n_edges, dtype=np.int32)
    else:
        raise ValueError(model)
    etype = None
    if n_edge_types is not None:
        etype = rng.integers(0, n_edge_types, size=n_edges, dtype=np.int32)
    g = Graph(src=src, dst=dst, n_vertices=n_vertices, edge_type=etype, name=name)
    g.validate()
    return g


#: paper Table 3 — (V, E, degree model)
PAPER_DATASETS: Dict[str, Tuple[int, int, str]] = {
    "ak2010": (45_293, 108_549, "uniform"),        # redistricting set
    "coAuthorsDBLP": (299_068, 977_676, "powerlaw"),
    "hollywood-2009": (1_139_905, 57_515_616, "powerlaw"),
    "cit-Patents": (3_774_768, 16_518_948, "powerlaw"),
    "soc-LiveJournal1": (4_847_571, 43_369_619, "powerlaw"),
    "europe-osm": (50_912_018, 54_054_660, "uniform"),
}


def paper_graph(dataset: str, scale: float = 1.0, seed: int = 0,
                n_edge_types: Optional[int] = None) -> Graph:
    """Synthetic stand-in matched to a paper dataset's V/E counts.

    ``scale`` < 1 shrinks both V and E proportionally (CPU-friendly runs);
    the degree distribution family is preserved.
    """
    v, e, model = PAPER_DATASETS[dataset]
    v, e = max(4, int(v * scale)), max(4, int(e * scale))
    return random_graph(v, e, seed=seed, model=model, n_edge_types=n_edge_types,
                        name=f"{dataset}@{scale:g}")
