"""Where a traced run's time went, by the program's spans and counters.

    python3 gnnbench/span_report.py --workload <name> --seeds 11,12 \\
        [--seconds 51] [--out span_report.jsonl]

Runs the cell as ``run.py --trace 1`` does, once for each seed, and
prints one JSON line a run (and appends it to ``--out``): ``correct``,
the cell's per-layer metrics, the counters, ``span_self_ms`` (self time by
span name: total, median, count) and ``idle_by_span`` (device idle seconds
by the innermost program span open on a worker, shared when several are,
else "no batch in flight").  A serving cell adds ``batch_stages_ms`` (the
median over batches of the time each stage took in a batch, and the
share of it the thread was on a CPU), ``batches`` (``serve.batch`` spans,
and the batches ``ServeMetrics`` counted), ``children_fit`` (whether each
batch's stages sum to no more than its span) and ``clock_check``: the
share of kernel time (copies and sets aside) inside some batch's interval
from its ``serve.batch`` start to its device completion, widened by 50
microseconds.  Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CLOCK_PAD_NS = 50_000


def _stages(rec: dict) -> dict:
    """Per stage: the median over batches of its time in a batch, ms, and
    its CPU share; plus whether each batch's children fit in it."""
    from gnnbench import spanread

    batches = {b["id"]: b for b in spanread.named(rec, "serve.batch")}
    parent = {s["id"]: s["parent"] for s in rec["spans"]}

    def batch_of(i):
        while i is not None and i not in batches:
            i = parent.get(i)
        return i

    per: dict = {}
    fit = True
    kids_ns = {i: 0 for i in batches}
    for s in rec["spans"]:
        b = batch_of(s["parent"])
        if b is None:
            continue
        d = s["end_ns"] - s["start_ns"]
        if s["parent"] == b:
            kids_ns[b] += d
        row = per.setdefault(s["name"], {}).setdefault(b, [0, 0])
        row[0] += d
        row[1] += s["cpu_ns"] or 0
    for i, b in batches.items():
        fit &= kids_ns[i] <= b["end_ns"] - b["start_ns"]
    out = {"serve.batch": dict(
        median_ms=statistics.median(b["end_ns"] - b["start_ns"]
                                    for b in batches.values()) / 1e6,
        cpu_share=sum(b["cpu_ns"] for b in batches.values())
        / max(1, sum(b["end_ns"] - b["start_ns"] for b in batches.values())))}
    for name, rows in sorted(per.items()):
        ns = [r[0] for r in rows.values()]
        out[name] = dict(median_ms=statistics.median(ns) / 1e6,
                         cpu_share=sum(r[1] for r in rows.values()) / max(1, sum(ns)),
                         batches=len(rows))
    return dict(batch_stages_ms=out, children_fit=bool(fit))


def clock_check(rec: dict, prof) -> float:
    """Percent of kernel time inside a batch's widened interval."""
    from gnnbench import spanread

    keep = [i for i, n in enumerate(prof.dev_names) if prof.is_kernel(n)]
    kernels = prof.dev_t[keep]
    total = int((kernels[:, 1] - kernels[:, 0]).sum())
    cover = spanread._union(spanread.batch_intervals(rec, CLOCK_PAD_NS))
    return 100.0 * spanread._covered(cover, kernels) / total if total else float("nan")


def report(cell, seed: int, seconds: float, device) -> dict:
    from gnnbench import spanread
    from gnnbench.check import judge

    out = cell.driver.run(cell, seed, seconds, True, device)
    prof = out.reading["profile"]
    rec = spanread.export()
    line = dict(workload=cell.name, seed=seed,
                correct=judge(out.check(), cell.limits),
                metrics={m.name: m.reader.read(out.reading) for m in cell.per_layer},
                counters=rec["counters"],
                span_self_ms=spanread.span_self_ms(rec),
                idle_by_span=spanread.idle_by_span(rec, prof.gaps),
                busy_s=prof.busy_s, window_s=prof.window_s,
                notes={k: v for k, v in out.notes.items() if k != "setup_steps_s"})
    if "serve" in out.reading:
        line.update(_stages(rec))
        line["batches"] = dict(spans=len(spanread.named(rec, "serve.batch")),
                               serve_metrics=out.reading["serve"]["batches"])
        if device.type == "cuda":
            line["clock_check"] = clock_check(rec, prof)
    out.release()
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from gnnbench.cell import load_benchmark, load_cell
    from gnnbench.run import card, card_device

    cell = load_cell(args.workload)
    dev = card_device(cell.chips)
    if dev is None:
        print("span_report: no CUDA card is visible", file=sys.stderr)
        return 2
    seconds = args.seconds or load_benchmark()["run_seconds"]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        line = report(load_cell(args.workload), seed, seconds, dev)
        line.update(card=card(), report_s=time.perf_counter() - t0)
        text = json.dumps(line, default=float)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
