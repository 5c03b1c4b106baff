"""Median over batches of how long the device ran on after the host had
enqueued a batch, ms: the batch's device completion (an event at the end
of its ``serve.batch`` span) less the end of its ``runner.run`` span.
Nothing off a CUDA card."""
from gnnbench import spanread


def read(reading):
    return spanread.device_trail_ms()
