"""Median time a worker spends on a batch, ms: the program's ``serve.batch``
span, from dispatch until the outputs are handed to the tickets (merge,
tiling, inputs, cache, bind and the runner's enqueue), over the traced
window's batches."""
from gnnbench import spanread


def read(reading):
    return spanread.median_ms("serve.batch")
