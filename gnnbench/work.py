"""The benchmark's frozen work counts for rooflines and ``mfu``.

Counted from the graph (vertices V, edges E) and the width F alone, never
from tiles, plans or padding, so the count is the same whatever
implements the layer.  Float32 values, int32 indices.
"""
from __future__ import annotations

from . import peaks


def aggregation_bytes(V: int, E: int, F: int, gat: bool) -> float:
    """One layer's aggregation: each edge's (src, dst) indices, the source
    rows read once, the destination rows written once; GAT adds the two
    per-vertex attention terms."""
    b = E * 8 + V * F * 4 + V * F * 4
    return b + 2 * V * 4 if gat else b


def aggregation_flops(V: int, E: int, F: int, gat: bool) -> float:
    """One layer's aggregation: a multiply-add per edge and feature."""
    return 2.0 * E * F


def aggregation_bound_s(V: int, E: int, F: int, gat: bool) -> float:
    """The least time one layer's aggregation takes on the card."""
    return max(aggregation_bytes(V, E, F, gat) / peaks.HBM_BYTES_PER_S,
               aggregation_flops(V, E, F, gat) / peaks.FP32_FLOPS_PER_S)


def layer_flops(V: int, E: int, F: int, gat: bool) -> float:
    """Model FLOPs of one layer: the dense transform and the aggregation;
    GAT adds the two attention mat-vecs and the edge softmax."""
    f = 2.0 * V * F * F + 2.0 * E * F
    return f + 4.0 * V * F + 5.0 * E if gat else f
