"""Percent of the traced window's device idle time that some batch covers,
from its ``serve.batch`` start to its device completion: idle time the
device spends waiting on a batch's host work, not for a batch to form.
Nothing off a CUDA card."""
from gnnbench import spanread


def read(reading):
    return spanread.idle_in_batch(reading)
