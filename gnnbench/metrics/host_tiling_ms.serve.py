"""Median host tiling of a batch, ms: the program's ``engine.tile`` span
around the shape registry's canonical tiling, its wait for the registry's
lock (``engine.tile_wait``) included."""
from gnnbench import spanread


def read(reading):
    return spanread.median_ms("engine.tile")
