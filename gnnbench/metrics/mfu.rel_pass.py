"""R-GCN's model FLOPs (``work_rel.layer_flops``) of the passes outside
the traced stretch over their time and the card's float32 peak, percent."""
from gnnbench import work_rel
from gnnbench.roofline import mfu


def read(reading):
    if "relations" not in reading:
        return None
    (V, E, _), = reading["graphs"]
    flops = reading["layers"] * work_rel.layer_flops(
        V, E, reading["F"], reading["relations"], reading["bases"])
    return mfu(reading["passes"] * flops, reading["passes_s"])
