"""Time the relation-grouped edge GEMM against its plain version on the card.

    python3 tools/relgemm_time.py [--edges 1955352] [--relations 206]
        [--width 128] [--table 299068] [--reps 20]

At the R-GCN cell's shapes by default: E messages with Zipf-distributed
relation types, each reading a row of a (table, width) store in place, and
R (width, width) weights.  Prints one JSON line: the card and its power
limit, the median ms of CUDA-event-timed calls of the kernel and of the
plain version (one matmul a relation), the plan's median ms, and the
kernel's bound (``gnnbench/work_rel.py``).  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def timed_ms(fn, reps: int) -> float:
    import torch

    fn()                                        # warm: builds, allocates
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--edges", type=int, default=1_955_352)
    p.add_argument("--relations", type=int, default=206)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--table", type=int, default=299_068)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch
    from gnnbench import work_rel
    from repro_torch.kernels.relation_gemm import ops

    if not torch.cuda.is_available():
        print("relgemm_time: no CUDA card is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    E, R, F = args.edges, args.relations, args.width
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    zipf = 1.0 / torch.arange(1, R + 1, dtype=torch.float64)
    types = torch.multinomial(zipf / zipf.sum(), E, replacement=True, generator=gen).to(dev)
    rows = torch.randint(0, args.table, (E,), generator=gen).to(dev)
    x = torch.randn(args.table, F, generator=gen).to(dev)
    w = (torch.randn(R, F, F, generator=gen) / F ** 0.5).to(dev)
    plan = ops.read_rows(ops.relation_plan(types, R), rows)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps(dict(
        card=card, edges=E, relations=R, width=F, table=args.table,
        kernel_ms=timed_ms(lambda: ops.relation_gemm(x, w, plan), args.reps),
        plain_ms=timed_ms(lambda: ops.relation_gemm_ref(x, w, plan), args.reps),
        plan_ms=timed_ms(lambda: ops.read_rows(ops.relation_plan(types, R), rows),
                         args.reps),
        bound_ms=1e3 * work_rel.relgemm_bound_s(E, F, F, R))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
