"""Source rows the whole-graph passes' source blocks ran their vertex ops
over, per vertex of the graph: the program's counters
``runner.src_rows_computed`` over ``runner.vertices``, over the traced
passes.  Nothing where the program has no such counter."""
from gnnbench import spanread


def read(reading):
    rec = spanread.export()
    c = rec["counters"] if rec else {}
    if "runner.src_rows_computed" not in c or not c.get("runner.vertices"):
        return None
    return c["runner.src_rows_computed"] / c["runner.vertices"]
