"""Model FLOPs of the passes outside the traced stretch over their time
and the card's float32 peak, percent."""
from gnnbench.roofline import mfu, model_flops


def read(reading):
    (V, E, _), = reading["graphs"]
    return mfu(reading["passes"] * model_flops(reading, V, E), reading["passes_s"])
