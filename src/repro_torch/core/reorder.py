"""Graph reordering (paper §5.3): lightweight Degree Sorting.

Vertices are relabeled in descending in-degree order, concentrating the
high-connectivity vertices into the low-id source partitions so sparse tiles
on the high-id side shrink (more blank rows skipped).  Returns the permuted
graph plus the mappings needed to permute features in and outputs back.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..gnn.graphs import Graph


@dataclasses.dataclass
class Reordering:
    graph: Graph
    order: np.ndarray  # (V,) old vertex id occupying each new slot: old = order[new]
    rank: np.ndarray   # (V,) new id of each old vertex:            new = rank[old]
    mode: str = "identity"  # provenance tag carried into runner/cache signatures

    def permute_vertex_features(self, x: np.ndarray) -> np.ndarray:
        """X_new[new] = X_old[order[new]]"""
        return x[self.order]

    def unpermute_vertex_outputs(self, y_new: np.ndarray) -> np.ndarray:
        """y_old[old] = y_new[rank[old]]"""
        return y_new[self.rank]

    @property
    def is_identity(self) -> bool:
        return self.mode == "identity"


def identity_order(graph: Graph) -> Reordering:
    order = np.arange(graph.n_vertices, dtype=np.int32)
    return Reordering(graph=graph, order=order, rank=order.copy(), mode="identity")


def degree_sort(graph: Graph, by: str = "in") -> Reordering:
    """Heuristic Degree Sorting (paper Fig 7c): stable sort by degree desc."""
    if by not in ("in", "out"):
        raise ValueError(f"degree_sort: by must be 'in' or 'out', got {by!r}")
    deg = graph.in_degrees() if by == "in" else graph.out_degrees()
    order = np.argsort(-deg, kind="stable").astype(np.int32)
    rank = np.empty_like(order)
    rank[order] = np.arange(graph.n_vertices, dtype=np.int32)
    g2 = Graph(src=rank[graph.src], dst=rank[graph.dst],
               n_vertices=graph.n_vertices, edge_type=graph.edge_type,
               name=graph.name + "+degsort")
    g2.validate()
    mode = "degree" if by == "in" else "degree-out"
    return Reordering(graph=g2, order=order, rank=rank, mode=mode)
