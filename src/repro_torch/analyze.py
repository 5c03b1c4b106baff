"""Static analysis CLI (ISSUE 6).

Runs the compiler verifier stack — IR dataflow checks, schedule legality,
kernel-dispatch lints, the stream-task race detector, and the static
exchange census — over the paper-model matrix without executing anything.

Usage:
  PYTHONPATH=src python -m repro.analyze                       # 5 models x {1,2,3} layers
  PYTHONPATH=src python -m repro.analyze --models gcn,gat --layers 2
  PYTHONPATH=src python -m repro.analyze --all --fail-on error # CI gate (+ task graphs)
  PYTHONPATH=src python -m repro.analyze --json report.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

from .core import analysis as A
from .core import compiler, isa, tiling
from .core.streams import HWConfig, build_task_graph
from .gnn import graphs, models

#: deterministic tile-set substrate for the task-graph analyses (--all)
_GRAPH_SPEC = dict(n_vertices=150, n_edges=600, seed=3, model="powerlaw",
                   n_edge_types=3)


def _cell_name(name: str, n_layers: int) -> str:
    return f"{name} x{n_layers}"


def analyze_matrix(names: List[str], layer_counts: List[int], dim: int,
                   with_task_graphs: bool) -> Dict[str, List[A.Diagnostic]]:
    """Every analysis pass over every (model, layers) cell; returns
    cell title -> diagnostics (compile failures become ZA-coded errors
    via the raised VerificationError's own diagnostics)."""
    report: Dict[str, List[A.Diagnostic]] = {}
    g = graphs.random_graph(**_GRAPH_SPEC) if with_task_graphs else None
    for name in names:
        for n_layers in layer_counts:
            tr = models.trace_stacked(name, n_layers, dim, dim, dim)
            # verify=False: the CLI reports findings instead of raising
            c = compiler.compile_gnn(tr, verify=False)
            diags = A.verify_ir(c.ir)
            for dispatch in (True, False):
                sp = c.schedule(kernel_dispatch=dispatch)
                diags += A.verify_schedule(sp)
                # ShardedRunner executes either schedule variant, so the
                # exchange census must hold for both: exactly n_layers
                # gather-tainted collectives, kernels on or off
                diags += A.verify_exchange(sp)
            if with_task_graphs:
                ts = tiling.grid_tile(g, 4, 4, sparse=True)
                sde = isa.emit_sde(c.schedule(True))
                hw = HWConfig()
                for mode in ("barrier", "pipelined"):
                    tasks, _ = build_task_graph(sde, ts, hw, inter_layer=mode)
                    diags += A.analyze_task_graph(tasks, sde=sde, tiles=ts,
                                                  inter_layer=mode)
                # per-chip view: boundary reads outside the chip's
                # partitions must surface as cross-chip (ZH206), not races
                tasks, _ = build_task_graph(sde, ts, hw,
                                            inter_layer="pipelined",
                                            parts=[0, 1])
                diags += A.analyze_task_graph(tasks, sde=sde, tiles=ts,
                                              inter_layer="pipelined",
                                              parts=[0, 1])
            report[_cell_name(name, n_layers)] = diags
    return report


def render_codes_doc() -> str:
    """``docs/DIAGNOSTICS.md``, generated from the ``analysis.CODES``
    registry so the doc can never drift from the code (a test pins the file
    to this function's output; regenerate with ``--write-codes-doc``)."""
    families = (
        ("ZA", "IR verifier (`verify_ir`)",
         "Structural checks over the optimized `IRProgram`: op vocabulary, "
         "def-use, dim re-inference, channel pairing, cycles, layer tags."),
        ("ZS", "Schedule verifier (`verify_schedule`)",
         "Legality of the lowered `ScheduledProgram`: gather ownership, "
         "kernel-tag preconditions re-derived from the IR, cross-phase "
         "dataflow, accumulator specs, missed-kernel lints."),
        ("ZH", "Hazard analyzer & exchange census (`analyze_task_graph`, "
         "`verify_exchange`)",
         "Races and collective structure over stream-task graphs: drain "
         "ordering, barrier coverage, the exactly-one-collective-per-layer "
         "census, gather taint of exchanged values, and the "
         "restricted-exchange coverage proof (every cross-shard source "
         "read in its owner's send set, `recvDst` rows device-local, "
         "send sets owned by their shard)."),
    )
    lines = [
        "# Diagnostics catalog",
        "",
        "Every code the static analysis layer (`src/repro/core/analysis/`) "
        "can emit, with its default severity.  Codes are **append-only** — "
        "tests and downstream tooling key on them, so they are never "
        "renumbered.  See [ARCHITECTURE.md](../ARCHITECTURE.md) for where "
        "each pass runs; `python -m repro.analyze --all` sweeps the full "
        "paper-model matrix.",
        "",
        "This file is generated from `repro.analysis.CODES` by",
        "`python -m repro.analyze --write-codes-doc docs/DIAGNOSTICS.md`;",
        "`tests/test_docs.py` pins it byte-for-byte, so regenerate after "
        "touching the registry.",
    ]
    for prefix, title, blurb in families:
        lines += ["", f"## {prefix}xxx — {title}", "", blurb, "",
                  "| code | severity | meaning |", "| --- | --- | --- |"]
        for code in sorted(c for c in A.CODES if c.startswith(prefix)):
            sev, meaning = A.CODES[code]
            lines.append(f"| `{code}` | {sev} | {meaning} |")
    lines += ["",
              f"Total: {len(A.CODES)} registered codes "
              f"({sum(1 for s, _ in A.CODES.values() if s == 'error')} error, "
              f"{sum(1 for s, _ in A.CODES.values() if s == 'warn')} warn, "
              f"{sum(1 for s, _ in A.CODES.values() if s == 'info')} info).",
              ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.analyze",
        description="Static verification of compiled GNN programs.")
    ap.add_argument("--models", default=",".join(models.PAPER_MODELS),
                    help="comma-separated model names "
                         f"(default: {','.join(models.PAPER_MODELS)})")
    ap.add_argument("--layers", default="1,2,3",
                    help="comma-separated layer counts (default: 1,2,3)")
    ap.add_argument("--dim", type=int, default=16, help="feature dim")
    ap.add_argument("--all", action="store_true",
                    help="also analyze stream-task graphs (barrier, "
                         "pipelined, and a per-chip pipelined view)")
    ap.add_argument("--fail-on", default="error",
                    choices=["error", "warn", "info", "never"],
                    help="exit non-zero if a finding at or above this "
                         "severity exists (default: error)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write all findings to PATH as JSON")
    ap.add_argument("--write-codes-doc", metavar="PATH", default=None,
                    help="write the diagnostics catalog (docs/DIAGNOSTICS.md)"
                         " generated from the CODES registry, then exit")
    args = ap.parse_args(argv)

    if args.write_codes_doc:
        parent = os.path.dirname(args.write_codes_doc)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.write_codes_doc, "w") as f:
            f.write(render_codes_doc())
        print(f"wrote {args.write_codes_doc} ({len(A.CODES)} codes)")
        return 0

    names = [m.strip() for m in args.models.split(",") if m.strip()]
    for m in names:
        if m not in models.MODELS:
            ap.error(f"unknown model {m!r} (have: {sorted(models.MODELS)})")
    layer_counts = [int(x) for x in args.layers.split(",") if x.strip()]

    report = analyze_matrix(names, layer_counts, args.dim, args.all)

    worst_rank = len(A.SEVERITIES)
    for cell, diags in report.items():
        print(A.format_report(diags, title=cell))
        w = A.worst_severity(diags)
        if w is not None:
            worst_rank = min(worst_rank, A.SEVERITIES.index(w))
    n_findings = sum(len(d) for d in report.values())
    n_errors = sum(len(A.errors(d)) for d in report.values())
    print(f"== {len(report)} cell(s), {n_findings} finding(s), "
          f"{n_errors} error(s)")

    if args.json:
        payload = {cell: [d.to_dict() for d in A.sort_diags(diags)]
                   for cell, diags in report.items()}
        parent = os.path.dirname(args.json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}")

    if args.fail_on != "never" and worst_rank <= \
            A.SEVERITIES.index(args.fail_on):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
