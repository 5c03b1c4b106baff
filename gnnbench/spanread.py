"""The program's spans and counters, as a traced run leaves them.

The port's recorder (``repro_torch.spans``) records while ``torch.profiler``
traces, so a traced run holds its spans and counters beside the device
trace, on the trace's clock.  Each function returns ``None`` where there
is nothing to read: a program without the recorder, no span of the name,
or, for what needs the device's completion times, no CUDA card.
"""
from __future__ import annotations

import importlib
import statistics
from typing import Dict, List, Optional

import numpy as np

from gnnbench.check import nearest_rank

NO_BATCH = "no batch in flight"


def export() -> Optional[Dict]:
    """The recorder's last stretch; ``None`` when the program has none."""
    try:
        spans = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    rec = spans.export()
    return rec if rec["spans"] or rec["counters"] else None


def named(rec: Optional[Dict], name: str) -> List[Dict]:
    return [] if rec is None else [s for s in rec["spans"] if s["name"] == name]


def median_ms(name: str) -> Optional[float]:
    """Median duration of the spans ``name``, ms."""
    d = [s["end_ns"] - s["start_ns"] for s in named(export(), name)]
    return statistics.median(d) / 1e6 if d else None


def device_trail_ms() -> Optional[float]:
    """Median over batches of the device's completion less the end of the
    batch's last ``runner.run`` (the host's enqueue), ms."""
    rec = export()
    run_end: Dict[int, int] = {}
    for s in named(rec, "runner.run"):
        if "batch" in s:
            run_end[s["batch"]] = max(run_end.get(s["batch"], 0), s["end_ns"])
    d = [b["device_end_ns"] - run_end[b["batch"]] for b in named(rec, "serve.batch")
         if "device_end_ns" in b and b["batch"] in run_end]
    return statistics.median(d) / 1e6 if d else None


def tail_queue_ms() -> Optional[float]:
    """Median queue wait (``serve.queue``) of the requests whose time from
    admission to their batch's completion is at or above that time's 95th
    percentile, ms."""
    rec = export()
    # off a card a batch's work is done when the host returns
    done = {b["batch"]: b.get("device_end_ns", b["end_ns"])
            for b in named(rec, "serve.batch")}
    reqs = [(done[q["batch"]] - q["start_ns"], q["end_ns"] - q["start_ns"])
            for q in named(rec, "serve.queue") if q["batch"] in done]
    if not reqs:
        return None
    p95 = nearest_rank([r for r, _ in reqs], 95)
    return statistics.median(w for r, w in reqs if r >= p95) / 1e6


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the (n, 2) intervals ``iv``."""
    out: List[List[int]] = []
    for s, e in iv[np.argsort(iv[:, 0], kind="stable")]:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, np.int64).reshape(-1, 2)


def _covered(cover: np.ndarray, iv: np.ndarray) -> int:
    """ns of the intervals ``iv`` that the disjoint sorted ``cover`` covers."""
    if not len(cover) or not len(iv):
        return 0
    lens = cover[:, 1] - cover[:, 0]
    before = np.concatenate([[0], np.cumsum(lens)])

    def upto(t):                         # cover's length before each t
        k = np.searchsorted(cover[:, 0], t, side="right")
        inside = np.clip(t - cover[np.maximum(k - 1, 0), 0], 0,
                         lens[np.maximum(k - 1, 0)])
        return before[np.maximum(k - 1, 0)] + np.where(k > 0, inside, 0)

    return int((upto(iv[:, 1]) - upto(iv[:, 0])).sum())


def batch_intervals(rec: Optional[Dict], pad_ns: int = 0) -> np.ndarray:
    """Each batch from its ``serve.batch`` start to its device completion,
    widened by ``pad_ns``; empty without device completion times."""
    return np.array([(b["start_ns"] - pad_ns, b["device_end_ns"] + pad_ns)
                     for b in named(rec, "serve.batch") if "device_end_ns" in b],
                    np.int64).reshape(-1, 2)


def idle_in_batch(reading: Dict) -> Optional[float]:
    """Percent of the traced window's device idle time (the gaps between
    its device operations) that some batch covers, from its
    ``serve.batch`` start to its device completion."""
    prof = reading.get("profile")
    batches = batch_intervals(export())
    if prof is None or not len(batches) or not len(prof.gaps):
        return None
    idle = int((prof.gaps[:, 1] - prof.gaps[:, 0]).sum())
    return 100.0 * _covered(_union(batches), prof.gaps) / idle if idle else None


def src_rows() -> Optional[float]:
    """Source rows the runner's batches computed over, padded, per vertex
    of the graph, over the traced runs."""
    rec = export()
    c = rec["counters"] if rec else {}
    if not c.get("runner.vertices"):
        return None
    return c.get("runner.src_rows_padded", 0) / c["runner.vertices"]


# ---- breakdowns of a traced run (not metrics) -------------------------------

def span_self_ms(rec: Dict) -> Dict[str, Dict[str, float]]:
    """Self time by span name: total and median, ms, and the count."""
    from repro_torch.spans import self_ns

    own = self_ns(rec["spans"])
    by: Dict[str, List[int]] = {}
    for s in rec["spans"]:
        by.setdefault(s["name"], []).append(own[s["id"]])
    return {n: dict(total=sum(v) / 1e6, median=statistics.median(v) / 1e6,
                    count=len(v))
            for n, v in sorted(by.items())}


def idle_by_span(rec: Dict, gaps: np.ndarray) -> Dict[str, float]:
    """Device idle seconds by the innermost program span open on a worker
    (shared equally when several workers have one open), else
    ``NO_BATCH``."""
    # each stacked span's own pieces: its interval less its children's
    kids: Dict[int, List[Dict]] = {}
    for s in rec["spans"]:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append(s)
    events = []                          # (time, +1 / -1, name)
    for s in rec["spans"]:
        if s["cpu_ns"] is None:          # stamped elsewhere, on no stack
            continue
        at = s["start_ns"]
        for c in sorted(kids.get(s["id"], []), key=lambda c: c["start_ns"]):
            if c["start_ns"] > at:
                events += [(at, 1, s["name"]), (c["start_ns"], -1, s["name"])]
            at = max(at, c["end_ns"])
        if s["end_ns"] > at:
            events += [(at, 1, s["name"]), (s["end_ns"], -1, s["name"])]
    for a, b in gaps:
        events += [(int(a), 2, None), (int(b), -2, None)]
    events.sort(key=lambda e: (e[0], e[1]))
    out: Dict[str, float] = {}
    open_: Dict[str, int] = {}
    idle, last = 0, None
    for t, kind, name in events:
        if idle and last is not None and t > last:
            n = sum(open_.values())
            for k, m in open_.items():
                out[k] = out.get(k, 0.0) + (t - last) * m / n / 1e9
            if not n:
                out[NO_BATCH] = out.get(NO_BATCH, 0.0) + (t - last) / 1e9
        if kind in (1, -1):
            open_[name] = open_.get(name, 0) + kind
            if not open_[name]:
                del open_[name]
        else:
            idle += kind // 2
        last = t
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
