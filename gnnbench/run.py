"""Run one cell of the port's benchmark once and print its result line.

    python3 gnnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.  Exits
2 without a result when no CUDA card (or too few) is visible, and 3 when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()            # set-up counts from here

import argparse                     # noqa: E402
import gc                           # noqa: E402
import json                         # noqa: E402
import subprocess                   # noqa: E402
import sys                          # noqa: E402
from pathlib import Path            # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unreadable: {exc!r}"


def card_device(chips: int = 1):
    """The first card, set as every run of the benchmark has it (float32
    with TF32 off, its context made), or ``None`` when fewer than
    ``chips`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.empty(1, device="cuda")              # the CUDA context
    return torch.device("cuda")


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t0: float = T0, marks: dict = None) -> dict:
    """Run ``cell`` once on ``device``; the result line as a dict.
    ``marks``: seconds of set-up spent before the cell's own, by step."""
    import torch
    from gnnbench.check import judge

    out = cell.driver.run(cell, seed, seconds, trace, device)
    setup_s = out.window_start - t0
    found = forbidden_modules()
    if found:
        raise ImportError(f"the run loaded {found}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = out.check()
    correct = judge(readings, cell.limits)
    prof = out.reading.get("profile")
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = m.reader.read(out.reading)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
    else:
        values = dict(out.metrics, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m.name] = {"value": float(values[m.name]), "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and prof is not None:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.window_s
        result["breakdown"] = {"device_ops": prof.device_ops(),
                               "idle_gaps": prof.idle_gaps()}
    steps = dict(marks or {}, **out.notes.get("setup_steps_s", {}))
    result["notes"] = dict(out.notes, setup_s=setup_s, setup_steps_s=steps)
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]["limit"]}
                        for k, v in readings.items() if k in cell.limits}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch
    from gnnbench.cell import load_cell

    t_torch = time.perf_counter()
    cell = load_cell(args.workload)
    device = card_device(cell.chips)
    if device is None:
        print(f"gnnbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "visible", file=sys.stderr)
        return 2
    t_cuda = time.perf_counter()
    marks = {"imports": t_torch - T0, "cuda_context": t_cuda - t_torch}
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         device, marks=marks)
    except ImportError as exc:
        print(f"gnnbench: {exc}", file=sys.stderr)
        return 3
    result["notes"]["card"] = card()
    print(json.dumps(result["notes"]), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
