"""Median queue wait (``serve.queue``: admission to dispatch), ms, of the
requests whose time from admission to their batch's completion is at or
above its 95th percentile: the part of the tail spent waiting for a batch.
Off a card a batch completes at the end of its ``serve.batch`` span."""
from gnnbench import spanread


def read(reading):
    return spanread.tail_queue_ms()
