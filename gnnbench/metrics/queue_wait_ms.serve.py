"""Median wait of a window request from admission to dispatch, in ms, as
the server's own ``ServeMetrics`` stamps it (its last 4,096 requests)."""


def read(reading):
    wait = reading["serve"]["queue_wait_s"]
    return 1e3 * wait["p50"] if wait["count"] else None
