"""Mean fill of the dispatched batches over the window, percent of the
batch cap, from the server's ``ServeMetrics``."""


def read(reading):
    fill = reading["serve"]["batch_fill"]
    return 100.0 * fill["mean"] if fill["count"] else None
