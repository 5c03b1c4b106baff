"""Median bind of a batch's tiles, ms: the program's ``runner.bind`` span
(tile arrays and constants to the device, edge plans and the COO
densify)."""
from gnnbench import spanread


def read(reading):
    return spanread.median_ms("runner.bind")
