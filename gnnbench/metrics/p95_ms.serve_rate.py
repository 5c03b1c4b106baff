"""95th percentile of every window request's latency, ms, nearest rank; a
shed or failed request counts as missing, at the longest wait.  The tail
that the served rate stands in for where host stalls swing it."""


def read(reading):
    return reading.get("p95_ms")
