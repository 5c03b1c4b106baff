"""Percent of the traced passes' window with no device operation running."""
from gnnbench.roofline import idle_share


def read(reading):
    return idle_share(reading)
