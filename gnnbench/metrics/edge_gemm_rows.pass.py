"""Rows the whole-graph passes' edge transforms ran over, per message of
the graph: the program's counters ``runner.edge_gemm_rows`` over
``runner.edges``, over the traced passes.  Nothing where the program has
no such counter."""
from gnnbench import spanread


def read(reading):
    rec = spanread.export()
    c = rec["counters"] if rec else {}
    if "runner.edge_gemm_rows" not in c or not c.get("runner.edges"):
        return None
    return c["runner.edge_gemm_rows"] / c["runner.edges"]
