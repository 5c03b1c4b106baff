"""Readings that a cell's limits and rate are set from, on the card.

    python3 gnnbench/control.py --workload <name> --seeds 11,12,13 \\
        [--program-seeds 21,22,...] [--rates 400,800] [--seconds 10]

For each of ``--seeds``: the control, the plain reference put in the
program's place and computed in TF32 (the nearest precision below the
configurations' float32), held against the float32 reference on the units
a run of ``--seconds`` compares, at the cell's own sizes.  For each of
``--program-seeds``: a whole run of the cell with that window, and its
readings; with ``--rates`` (an open-loop cell), one such run at each rate
in place of the mix's, judged by ``sustained``.  The knee is the highest
rate that every seed sustains, with every lower rate swept sustained too;
a cell offers 0.8 x its knee.  One JSON line per reading; all in one
process, so the set-up of the card is paid once.  Without a card it
exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TREND_MAX = 1.3     # latency of the last quarter of arrivals over the first's


def sustained(result: dict, rate: float, deadline_s: float) -> bool:
    """Whether an open-loop run kept up with ``rate``: every request
    served, p95 under the deadline, no latency growing through the window
    (``TREND_MAX``), and no more requests open at the last arrival than a
    steady queue holds at that rate and its p95 (Little's law)."""
    notes = result["notes"]
    p95_s = notes["p95_ms"] / 1e3
    return (result["failed"] == 0 and p95_s < deadline_s
            and notes["latency_trend"] <= TREND_MAX
            and notes["open_at_last_arrival"] <= rate * p95_s)


def control_readings(cell, seed: int, device, seconds: float) -> dict:
    """The comparison's readings with the TF32 reference as the program."""
    drv = cell.driver
    data = drv.make_data(cell, seed, device, seconds)
    outs = drv.reference_outputs(cell, data, drv.check_units(data), "tf32")
    return drv.compare(cell, data, outs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch
    from gnnbench.cell import load_benchmark, load_cell
    from gnnbench.run import card_device, execute

    cell = load_cell(args.workload)
    dev = card_device(cell.chips)
    if dev is None:
        print("control: no CUDA card is visible", file=sys.stderr)
        return 2
    seconds = args.seconds or load_benchmark()["run_seconds"]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        r = control_readings(cell, seed, dev, seconds)
        print(json.dumps(dict(workload=cell.name, kind="control", seed=seed,
                              readings=r)), flush=True)
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    for rate in rates:
        for seed in [int(s) for s in args.program_seeds.split(",") if s]:
            cell = load_cell(args.workload)
            line = dict(workload=cell.name, kind="program", seed=seed)
            if rate is not None:
                cell.traffic["rate_per_s"][cell.config_name] = rate
            res = execute(cell, seed, seconds, False, dev, t0=time.perf_counter())
            if rate is not None:
                line.update(rate_per_s=rate, sustained=sustained(
                    res, rate, cell.traffic["server"]["default_deadline_s"]))
            line.update(correct=res["correct"], failed=res["failed"],
                        metrics={k: m["value"] for k, m in res["metrics"].items()},
                        readings={k: c["value"] for k, c in res["checks"].items()},
                        notes=res["notes"])
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
