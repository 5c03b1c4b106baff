"""Shares of a roofline and of the card's peak, from a run's reading.

A reading lists the graphs whose work the traced stretch covers, as
``(vertices, edges, times)``, the model, its layers and width ``F``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from gnnbench import peaks, work


def kernel_roofline(reading: Dict, patterns: Sequence[str],
                    gat: bool) -> Optional[float]:
    """Percent: the bound of every layer's aggregation over the device
    time of the kernels named by ``patterns``; ``None`` when none ran."""
    prof = reading.get("profile")
    t = prof.kernel_seconds(patterns) if prof is not None else None
    if not t:
        return None
    F, layers = reading["F"], reading["layers"]
    bound = sum(k * layers * work.aggregation_bound_s(V, E, F, gat)
                for V, E, k in reading["graphs"])
    return 100.0 * bound / t


def idle_share(reading: Dict) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    prof = reading.get("profile")
    if prof is None or prof.window_s <= 0 or not prof.dev_names:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def model_flops(reading: Dict, V: int, E: int) -> float:
    return reading["layers"] * work.layer_flops(
        V, E, reading["F"], reading["model"] == "gat")


def mfu(flops: float, seconds: float) -> Optional[float]:
    """Percent of the card's float32 peak."""
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peaks.FP32_FLOPS_PER_S)
