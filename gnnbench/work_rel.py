"""The benchmark's frozen work counts for R-GCN's roofline and ``mfu``.

Counted from the vertices V, the messages E (inverse edges included), the
relations R (inverses included), the bases B and the width F alone, never
from tiles, plans or padding.  Float32 values, int32 indices.
"""
from __future__ import annotations

from . import peaks


def relgemm_flops(E: int, F_in: int, F_out: int) -> float:
    """One layer's edge transform: each message times its relation's
    (F_in, F_out) weight."""
    return 2.0 * E * F_in * F_out


def relgemm_bytes(E: int, F_in: int, F_out: int, R: int) -> float:
    """One layer's edge transform: each message's row read and its product
    written once, its source index and its type, every relation's weight."""
    return E * (F_in + F_out) * 4 + E * 8 + R * F_in * F_out * 4


def relgemm_bound_s(E: int, F_in: int, F_out: int, R: int) -> float:
    """The least time one layer's edge transform takes on the card."""
    return max(relgemm_flops(E, F_in, F_out) / peaks.FP32_FLOPS_PER_S,
               relgemm_bytes(E, F_in, F_out, R) / peaks.HBM_BYTES_PER_S)


def layer_flops(V: int, E: int, F: int, R: int, B: int) -> float:
    """Model FLOPs of one layer at width F: the edge transform, the
    self-connection, the basis combination and the normalised sum."""
    return 2.0 * E * F * F + 2.0 * V * F * F + 2.0 * R * B * F * F + 2.0 * E * F
