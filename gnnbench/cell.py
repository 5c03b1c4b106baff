"""Resolve a workload of ``BENCHMARK.json`` to its files, by name.

A cell is a configuration (``configs/<config>.json``) under a traffic mix
(``traffic/<traffic>.json``).  The mix names its loop kind
(``drivers/<loop>.py``), the configuration its model family
(``reference/<model>.py``); each per-layer metric is read by
``metrics/<name>.py`` and each cell's correctness limits sit in
``limits/<workload>.json``.  Adding a cell, a mix or a metric adds files
and entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Metric:
    """One metric entry of ``BENCHMARK.json`` (and its reader, per-layer)."""

    name: str
    unit: str
    entry: Dict
    reader: Optional[ModuleType] = None


@dataclasses.dataclass
class Cell:
    """Everything one workload needs, loaded from its files."""

    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    driver: ModuleType
    reference: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]
    limits: Dict


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> Dict:
    with open(path) as f:
        return json.load(f)


def import_file(path: Path) -> ModuleType:
    """Import one file of the benchmark as a module of its own."""
    name = "gnnbench_" + "_".join(
        path.relative_to(HERE).with_suffix("").parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _applies(entry: Dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default)."""
    bench = load_benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(REPO / cfg_entry["file"])
    traffic = _read_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [Metric(m["name"], m["unit"], m) for m in bench["end_to_end"]
           if _applies(m, name)]
    per_layer = [Metric(m["name"], m["unit"], m,
                        import_file(HERE / "metrics" / f"{m['name']}.py"))
                 for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                driver=import_file(HERE / "drivers" / f"{traffic['loop']}.py"),
                reference=import_file(HERE / "reference" / f"{config['model']}.py"),
                end_to_end=e2e, per_layer=per_layer,
                limits=_read_json(HERE / "limits" / f"{name}.json"))


def make_params(shapes: Dict[str, tuple], gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights, one normal draw for all of them, each leaf
    scaled by 1/sqrt(fan-in) as the port's ``init_params`` scales its own."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        fan_in = shape[0] if len(shape) > 1 else 1
        out[name] = (flat[at:at + n].view(shape) / fan_in ** 0.5).contiguous()
        at += n
    return out


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Outcome:
    """What a loop hands back once its window has closed."""

    window_start: float               # ``time.perf_counter()`` at its start
    attempted: int
    failed: int
    metrics: Dict[str, float]         # end-to-end metrics but ``setup_s``
    reading: Dict                     # what the per-layer readers read
    release: Callable[[], None]       # frees the program's state
    check: Callable[[], Dict[str, float]]    # the comparison's readings
    notes: Dict = dataclasses.field(default_factory=dict)
