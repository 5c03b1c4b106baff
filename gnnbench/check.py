"""The comparison that decides ``correct``, and the benchmark's percentile.

``rel_err`` is the widest gap between the program's output and the plain
reference's, over the largest reference magnitude of the same unit (a
pass, or one request's rows).  A cell's limits sit in
``limits/<workload>.json``, each with the readings it was set from.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|; inf on a shape mismatch or a
    non-finite output."""
    got = got.to(device=want.device, dtype=torch.float32)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (``q`` in (0, 100])."""
    xs = sorted(values)
    rank = max(1, math.ceil(len(xs) * q / 100.0))
    return xs[min(rank, len(xs)) - 1]


def judge(readings: Dict[str, float], limits: Dict) -> bool:
    """Every reading at or under its limit; a reading without a limit, or
    a limit without a reading, is not correct."""
    if set(readings) != set(limits):
        return False
    return all(readings[k] <= limits[k]["limit"] for k in readings)
