"""Source rows the whole-graph passes compute over, padded to each tile
batch's S_max, per vertex of the graph: the program's counters
``runner.src_rows_padded`` over ``runner.vertices``, over the traced
passes."""
from gnnbench import spanread


def read(reading):
    return spanread.src_rows()
