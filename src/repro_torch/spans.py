"""Spans and counters at the port's layer boundaries, kept in memory.

The recorder is off by default, and then a call site costs one test of
two flags: :func:`span` returns one shared no-op context and :func:`count`
and :func:`record` return at once.  It records between :func:`enable` and
:func:`disable`, and while a ``torch.profiler`` trace runs, so that a
trace of the device gets the host spans of the same stretch.  A stretch
starts at :func:`enable`, or at the first span or count that finds a
profiler trace running, and clears what the stretch before it recorded;
:func:`disable` lets a running trace keep the stretch until the trace
ends.  Nothing is written anywhere: :func:`export` returns the records.

A span has a name, its start and end, the thread that ran it, the span
open around it on that thread (its parent), the thread's CPU time inside
it (``time.thread_time_ns``: a span whose CPU time falls short of its
duration waited, for the interpreter lock, another lock or the device)
and ids.  A span takes its parent's ``batch`` id unless it names its own.
Counters are named integers summed over the stretch.

:func:`export` puts every time on the clock of ``torch.profiler``'s host
events, the wall clock (``time.time_ns``), by one offset taken when the
stretch starts; the stamps themselves come from :func:`clock`, the
monotonic clock the serving tier stamps admission and dispatch with.  On
a CUDA card the stretch starts with an anchor event, a span may record one
more event at its end (:meth:`Span.mark_device`), and export turns that
event into the time the device reached it, on the same clock: the anchor's
host time plus the events' elapsed time, scaled by a second anchor taken at
export for the drift between the card's clock and the host's.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

_ON = False          # a stretch is recording (with the profiler's flag, the test)

#: the recorder's clock in seconds; the server stamps with it too
clock = time.perf_counter


class Span:
    """One recorded interval; a context manager while it is open."""

    __slots__ = ("name", "ids", "id", "parent", "tid", "start_ns", "end_ns",
                 "cpu_ns", "event")

    def __init__(self, name: str, ids: Dict):
        self.name, self.ids = name, ids
        self.id = next(_REC.ids)
        self.parent = None
        self.tid = threading.get_ident()
        self.event = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
            if "batch" in stack[-1].ids:
                self.ids.setdefault("batch", stack[-1].ids["batch"])
        stack.append(self)
        self.cpu_ns = time.thread_time_ns()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        _stack().pop()
        _REC.spans.append(self)
        return False

    def mark_device(self, device: torch.device) -> None:
        """Record an event on ``device``'s current stream where the span's
        device work ends (nothing off a CUDA card)."""
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(device))


class _Noop:
    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def mark_device(self, device) -> None:
        pass


_NOOP = _Noop()
_TLS = threading.local()


def _stack() -> List[Span]:
    try:
        return _TLS.stack
    except AttributeError:
        _TLS.stack = []
        return _TLS.stack


def _host_and_device() -> tuple:
    """(host ns on ``clock``, a timing event the device reached then)."""
    torch.cuda.synchronize()
    h0 = time.perf_counter_ns()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    torch.cuda.synchronize()
    return (h0 + time.perf_counter_ns()) // 2, ev


def _wall_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of a
    few paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class _Recorder:
    """The records of the current stretch (one per process)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.following = False
        self.offset = 0
        self.anchor = None

    def start(self, following: bool) -> None:
        global _ON
        self.spans, self.counters = [], {}
        self.following = following
        self.offset = _wall_offset()
        self.anchor = (_host_and_device() if torch.cuda.is_available()
                       and torch.cuda.is_initialized() else None)
        _ON = True

    def live(self) -> bool:
        """Whether to record now; starts or ends a stretch that follows a
        profiler trace."""
        global _ON
        tracing = _profiler._is_profiler_enabled
        if _ON and (tracing or not self.following):
            return True
        with self.lock:
            if _ON and self.following and not tracing:
                _ON = False                     # the trace has ended
            elif not _ON and tracing:
                self.start(following=True)
            return _ON

    def span_dicts(self) -> List[Dict]:
        spans = sorted(self.spans, key=lambda s: s.start_ns)
        done = {}
        if self.anchor is not None and any(s.event is not None for s in spans):
            h0, e0 = self.anchor
            h1, e1 = _host_and_device()
            scale = (h1 - h0) / (e0.elapsed_time(e1) * 1e6)
            done = {s.id: h0 + round(e0.elapsed_time(s.event) * 1e6 * scale)
                    for s in spans if s.event is not None}
        out = []
        for s in spans:
            d = dict(s.ids, name=s.name, id=s.id, parent=s.parent, tid=s.tid,
                     start_ns=s.start_ns + self.offset,
                     end_ns=s.end_ns + self.offset, cpu_ns=s.cpu_ns)
            if s.id in done:
                d["device_end_ns"] = done[s.id] + self.offset
            out.append(d)
        return out


_REC = _Recorder()


def enable() -> None:
    """Clear the records and start recording."""
    with _REC.lock:
        _REC.start(following=False)


def disable() -> None:
    """Stop recording (a running profiler trace keeps it until it ends)."""
    global _ON
    with _REC.lock:
        _REC.following = True
        if not _profiler._is_profiler_enabled:
            _ON = False


def span(name: str, **ids) -> Span:
    """A context that records one span named ``name`` with ``ids``."""
    if not (_ON or _profiler._is_profiler_enabled) or not _REC.live():
        return _NOOP
    return Span(name, ids)


def record(name: str, start_s: float, end_s: float, **ids) -> None:
    """A span whose start and end were stamped with :func:`clock`
    elsewhere; it has no parent and no CPU time."""
    if not (_ON or _profiler._is_profiler_enabled) or not _REC.live():
        return
    s = Span(name, ids)
    s.start_ns, s.end_ns = round(start_s * 1e9), round(end_s * 1e9)
    s.cpu_ns = None
    _REC.spans.append(s)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not (_ON or _profiler._is_profiler_enabled) or not _REC.live():
        return
    with _REC.lock:
        _REC.counters[name] = _REC.counters.get(name, 0) + int(n)


def export() -> Dict:
    """The current or last stretch: ``spans``, a list of dicts sorted by
    start (``name``, ``id``, ``parent``, ``tid``, ``start_ns``, ``end_ns``
    and ``device_end_ns`` on the profiler's clock, ``cpu_ns``, and the
    span's ids), and ``counters``."""
    with _REC.lock:
        return {"spans": _REC.span_dicts(), "counters": dict(_REC.counters)}


def self_ns(spans: List[Dict]) -> Dict[int, int]:
    """Each exported span's duration less the durations of its children
    (which nest inside it on its thread), by id."""
    out = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans}
    for s in spans:
        if s["parent"] in out:
            out[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return out
