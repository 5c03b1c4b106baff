#!/usr/bin/env python3
"""Print the dry run's sweep as a markdown table: a row an architecture, a
column a shape, each entry the 16 x 16 and the 2 x 16 x 16 mesh's rank 0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both   # writes the cells
    python3 tools/dryrun_table.py [reports/dryrun_torch]

An entry reads ``GB fits TFLOP (AR/AG/RS/A2A)``: rank 0's bytes
(arguments + temp) in GB, whether they fit the card the record names,
TFLOP a rank, and collective GB a rank by kind (all-reduce / all-gather /
reduce-scatter / all-to-all); ``skipped`` or ``error`` otherwise.  Errors
and the single-pod probes' FLOPs against the full step's follow the table.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
MESHES = (("single", "16x16"), ("multipod", "2x16x16"))


def entry(rec) -> str:
    if rec is None or rec["status"] != "ok":
        return "—" if rec is None else rec["status"]
    mem = rec["memory"]
    gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9
    coll = "/".join(f"{rec['collective_bytes'][k] / 1e9:.3g}" for k in KINDS)
    return f"{gb:.4g} {'yes' if rec['fits'] else 'no'} {rec['flops'] / 1e12:.4g} ({coll})"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0]) if argv else ROOT / "reports" / "dryrun_torch"
    recs = {}
    for mesh, _ in MESHES:
        for f in sorted((root / mesh).glob("*.json")):
            r = json.loads(f.read_text())
            recs[r["arch"], r["shape"], mesh] = r
    archs = sorted({a for a, _, _ in recs})
    shapes = [s for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
              if any(k[1] == s for k in recs)]
    print("| arch | " + " | ".join(shapes) + " |")
    print("| --- |" + " --- |" * len(shapes))
    for a in archs:
        cells = []
        for s in shapes:
            got = [recs.get((a, s, m)) for m, _ in MESHES]
            if all(r is not None and r["status"] == "skipped" for r in got):
                cells.append("skipped")
            else:
                cells.append("<br>".join(f"{label}: {entry(r)}"
                                         for (_, label), r in zip(MESHES, got)))
        print(f"| {a} | " + " | ".join(cells) + " |")
    errors = [f"{a} {s} {m}: {r['error'][:100]}" for (a, s, m), r in recs.items()
              if r["status"] == "error"]
    n = {st: sum(r["status"] == st for r in recs.values()) for st in ("ok", "skipped")}
    print(f"\n{n['ok']} ok, {n['skipped']} skipped, {len(errors)} errors"
          + (": " + "; ".join(errors) if errors else ""))
    ratios = sorted((r["probe"]["totals"]["flops"] / r["flops"], a, s)
                    for (a, s, m), r in recs.items() if r["status"] == "ok" and "probe" in r)
    if ratios:
        print(f"probe totals / full step FLOPs over {len(ratios)} single-pod cells: "
              f"{ratios[0][0]:.4f} ({ratios[0][1]} {ratios[0][2]}) to "
              f"{ratios[-1][0]:.4f} ({ratios[-1][1]} {ratios[-1][2]}); "
              f"{sum(abs(q - 1) < 1e-9 for q, _, _ in ratios)} exact")


if __name__ == "__main__":
    main()
