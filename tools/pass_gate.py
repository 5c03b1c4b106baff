"""What gates a whole-graph pass of the R-GCN cell: the host or the card.

    python3 tools/pass_gate.py [--seed 11] [--rounds 4] [--passes 60]

Builds the cell rgcn2-dblp-rel-whole's runner as its driver does, then runs
``--rounds`` rounds of three loops of ``--passes`` passes each:

* ``closed``: pass, synchronise, as the benchmark's window does; the wall
  time of each;
* ``enqueue``: the same, split into the host's time to enqueue the pass
  (until the call returns) and its wait in the synchronise;
* ``device``: a pass queued behind a sleep kernel long enough that the
  host has enqueued all of it before the card starts it, timed by CUDA
  events around it: the card's own time for a pass, with no host gap.

``closed - device`` is what the host adds to a pass.  Prints one JSON line:
the card, its power limit, SM clock and temperature before and after, and
per loop the quartiles of each round.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CELL = "rgcn2-dblp-rel-whole"
SLEEP_CYCLES = 200_000_000       # ~0.1 s at 1.98 GHz: longer than an enqueue


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def quartiles(ms):
    return [round(q, 4) for q in statistics.quantiles(ms, n=4)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--passes", type=int, default=60)
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from gnnbench import cell as C
    from gnnbench import run as R
    from repro_torch.core import compiler
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.core.tiling import build_tiles
    from repro_torch.gnn import relational as RL
    import torch

    dev = R.card_device(1)
    if dev is None:
        print("pass_gate: no CUDA card is visible", file=sys.stderr)
        return 2
    cell = C.load_cell(CELL)
    cfg, tiling = cell.config, cell.config["whole_graph_tiling"]
    t0 = time.perf_counter()
    data = cell.driver.make_data(cell, args.seed, dev, 0.0)
    g, params = data["graph"], data["params"]
    graph, edge_inputs = RL.relational_graph(g.src, g.dst, data["rel"], g.n_vertices,
                                             cfg["relations"])
    tiles, ro = build_tiles(graph, tiling["n_dst_parts"], tiling["n_src_parts"],
                            layout=tiling["layout"])
    runner = PipelinedRunner(
        compiler.compile_gnn(RL.trace_rgcn(cfg["layers"], cfg["in_dim"], cfg["hidden_dim"],
                                           cfg["out_dim"], cfg["relations"])),
        ro.graph, tiles, kernel_dispatch=cfg["kernel_dispatch"], reordering=ro,
        device=dev)
    edge_inputs = {k: torch.as_tensor(v, device=dev) for k, v in edge_inputs.items()}
    inputs = [dict(edge_inputs, x=x) for x in data["feats"]]
    setup_s = time.perf_counter() - t0
    before = smi()
    rounds = []
    with torch.inference_mode():
        for x in inputs:
            RL.run(runner, x, params)
        torch.cuda.synchronize()
        n = 0
        for _ in range(args.rounds):
            closed, enq, wait, device = [], [], [], []
            for _ in range(args.passes):
                a = time.perf_counter()
                RL.run(runner, inputs[n % len(inputs)], params)
                torch.cuda.synchronize()
                closed.append(1e3 * (time.perf_counter() - a))
                n += 1
            for _ in range(args.passes):
                a = time.perf_counter()
                RL.run(runner, inputs[n % len(inputs)], params)
                b = time.perf_counter()
                torch.cuda.synchronize()
                enq.append(1e3 * (b - a))
                wait.append(1e3 * (time.perf_counter() - b))
                n += 1
            for _ in range(args.passes // 3):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda._sleep(SLEEP_CYCLES)
                s.record()
                RL.run(runner, inputs[n % len(inputs)], params)
                e.record()
                e.synchronize()
                device.append(s.elapsed_time(e))
                n += 1
            rounds.append(dict(closed=quartiles(closed), enqueue=quartiles(enq),
                               wait=quartiles(wait), device=quartiles(device)))
    print(json.dumps(dict(seed=args.seed, setup_s=setup_s, smi_before=before,
                          smi_after=smi(), passes=args.passes, rounds=rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
