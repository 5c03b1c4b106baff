"""Serving-path metrics: latency percentiles, queue depth, shed counts.

Every number the async tier reports flows through one thread-safe
:class:`ServeMetrics` registry so the scheduler, the worker pool, and the
warmup thread never hand-roll their own counters.  The registry is cheap to
update on the hot path (a lock + ring-buffer append) and snapshots to a
plain JSON-able dict (:meth:`ServeMetrics.snapshot`).  It is the
operator's aggregate view; the spans under it (one a request and a batch,
and the engine's and runner's stages) are :mod:`repro_torch.spans`', on
the same stamps.

Metric families (glossary lives in ``docs/SERVING.md``):

* **latency** — seconds from ``submit`` to ticket resolution, which comes
  when the batch's outputs are enqueued on the device, not computed (the
  device's part is not in it), reported as p50/p99/mean/max over a
  bounded reservoir;
* **queue depth** — pending requests sampled at every enqueue/dequeue;
* **batch fill** — realized batch size over the class cap per dispatched
  batch (1.0 = the scheduler always filled to the cap);
* **shed** — admission-control rejections, broken down by reason
  (``queue-full``, ``dropped-oldest``, ``deadline-expired``, ``shutdown``);
* **warmup** — background compile progress (done / total).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``samples`` (``q`` in [0, 100]).

    Args:
        samples: observed values; order does not matter.
        q: the percentile to report, e.g. ``50`` or ``99``.

    Returns:
        The nearest-rank percentile, or ``0.0`` for an empty sample set
        (serving dashboards prefer a zero row over a crash).
    """
    if not samples:
        return 0.0
    xs = sorted(samples)
    if q <= 0:
        return xs[0]
    rank = max(1, -(-len(xs) * q // 100))        # ceil(n*q/100), >= 1
    return xs[min(int(rank), len(xs)) - 1]


class Histogram:
    """Bounded-reservoir histogram with exact percentiles over the window.

    Keeps the most recent ``window`` observations (plus running count / sum /
    max over the full lifetime), so percentiles reflect recent behavior and
    memory stays bounded no matter how long the server runs.
    """

    def __init__(self, window: int = 4096):
        """Create an empty histogram keeping at most ``window`` samples."""
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._samples: List[float] = []
        self._next = 0                     # ring-buffer write cursor
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        """Add one observation (ring-buffer overwrite once full)."""
        value = float(value)
        if len(self._samples) < self.window:
            self._samples.append(value)
        else:
            self._samples[self._next] = value
            self._next = (self._next + 1) % self.window
        self.count += 1
        self.total += value
        self.max = max(self.max, value)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the retained window."""
        return percentile(self._samples, q)

    @property
    def mean(self) -> float:
        """Lifetime mean (not just the retained window)."""
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        """JSON-able summary: count, mean, max, p50/p90/p99."""
        return dict(count=self.count, mean=round(self.mean, 6),
                    max=round(self.max, 6),
                    p50=round(self.percentile(50), 6),
                    p90=round(self.percentile(90), 6),
                    p99=round(self.percentile(99), 6))


class ServeMetrics:
    """Thread-safe registry of every async-serving metric.

    One instance is shared by the scheduler thread, the worker pool, and the
    warmup task; all mutation happens under one lock (updates are tiny —
    integer bumps and ring-buffer appends).
    """

    def __init__(self, window: int = 4096):
        """Create an empty registry; ``window`` bounds each histogram."""
        self._lock = threading.Lock()
        self.latency = Histogram(window)          # submit -> outputs enqueued
        self.queue_wait = Histogram(window)       # enqueue -> dispatch seconds
        self.batch_fill = Histogram(window)       # realized / cap per batch
        self.queue_depth = Histogram(window)      # depth sampled on transitions
        self.submitted = 0
        self.completed = 0
        self.batches = 0
        self.shed: Dict[str, int] = {}
        self.warmup_total = 0
        self.warmup_done = 0

    # ------------------------------------------------------------ recording
    def on_submit(self, queue_depth: int) -> None:
        """Record an admitted request and the resulting queue depth."""
        with self._lock:
            self.submitted += 1
            self.queue_depth.record(queue_depth)

    def on_shed(self, reason: str) -> None:
        """Count one shed request under its structured reason."""
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def on_batch(self, n_requests: int, cap: int, queue_depth: int) -> None:
        """Record one dispatched batch: fill ratio + post-dispatch depth."""
        with self._lock:
            self.batches += 1
            self.batch_fill.record(n_requests / max(cap, 1))
            self.queue_depth.record(queue_depth)

    def on_complete(self, latency_s: float,
                    queue_wait_s: Optional[float] = None) -> None:
        """Record one served request's latency (submit to outputs
        enqueued) and queue wait (submit to dispatch)."""
        with self._lock:
            self.completed += 1
            self.latency.record(latency_s)
            if queue_wait_s is not None:
                self.queue_wait.record(queue_wait_s)

    def on_warmup(self, done: int, total: int) -> None:
        """Update background-warmup progress (``done`` of ``total`` specs)."""
        with self._lock:
            self.warmup_done = done
            self.warmup_total = total

    # ------------------------------------------------------------ reporting
    @property
    def shed_count(self) -> int:
        """Total requests shed across every reason."""
        with self._lock:
            return sum(self.shed.values())

    def snapshot(self) -> Dict:
        """One JSON-able dict of every metric family (the export format)."""
        with self._lock:
            return dict(
                submitted=self.submitted,
                completed=self.completed,
                batches=self.batches,
                shed=dict(self.shed),
                shed_total=sum(self.shed.values()),
                warmup=dict(done=self.warmup_done, total=self.warmup_total),
                latency_s=self.latency.snapshot(),
                queue_wait_s=self.queue_wait.snapshot(),
                batch_fill=self.batch_fill.snapshot(),
                queue_depth=self.queue_depth.snapshot(),
            )

    def to_json(self, indent: int = 1) -> str:
        """Serialize :meth:`snapshot` as JSON text."""
        return json.dumps(self.snapshot(), indent=indent)
