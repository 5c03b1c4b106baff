"""Runner builds of the server's program cache during the window (0 once
every size class is warm)."""


def read(reading):
    return reading["builds"]
