"""Model FLOPs of the served requests over the sum of their latencies and
the card's float32 peak, percent: at a fixed rate the work in the window
cannot move, the work over latency can."""
from gnnbench.roofline import mfu, model_flops


def read(reading):
    flops = sum(model_flops(reading, V, E) for V, E, _ in reading["graphs"])
    return mfu(flops, sum(reading["latencies_s"])) if reading["graphs"] else None
