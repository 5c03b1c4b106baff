"""Source rows the whole-graph passes copied into (T, S_max, F) replicas,
kernel operands and edge blocks' source values alike, per vertex of the
graph: the program's counters ``runner.src_rows_replicated`` over
``runner.vertices``, over the traced passes.  0 where the tile kernels read
the flat store; nothing where the program has no such counter."""
from gnnbench import spanread


def read(reading):
    rec = spanread.export()
    c = rec["counters"] if rec else {}
    if "runner.src_rows_replicated" not in c or not c.get("runner.vertices"):
        return None
    return c["runner.src_rows_replicated"] / c["runner.vertices"]
