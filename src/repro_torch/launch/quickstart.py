"""Quickstart: the whole ZIPPER pipeline on one small graph, the
counterpart of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--scale 0.1] [--device cpu]

Traces a 2-layer GCN written against the whole-graph programming model
(one trace spanning both layers), compiles it to the graph-native IR
(cross-layer CSE and the E2V optimization included), tiles the graph
(sparse tiling with degree-sort reordering, ``build_tiles``), runs it on
the device through the whole-graph oracle ``run_reference`` and through
the tile interpreter's two one-call front ends, ``run_tiled`` and
``run_pipelined``, held against the oracle at 5e-4 x max(1, max |oracle|)
— and runs the
copied cycle-level simulator for the ZIPPER ASIC and a TPU-v5e-like
config, barrier against inter-layer pipelined schedule.  The simulator's
cycles and milliseconds are modelled by its cost model, not measured on
any chip; the one wall-clock printed is the pipelined engine's warm pass on
the device it ran on.  Runs on ``cuda`` unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import compiler, executor, isa, pipeline, simulator, tiling
from ..core.streams import TPU_V5E_LIKE, HWConfig
from ..device import resolve
from ..gnn import graphs, models

TOL = 5e-4   # engines vs the oracle, relative to max(1, max |oracle|)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1,
                    help="fraction of ak2010's vertices in the stand-in graph")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    g0 = graphs.paper_graph("ak2010", scale=args.scale, seed=0)
    print(f"graph: {g0.n_vertices} vertices, {g0.n_edges} edges")

    # 1. trace a 2-layer GCN (one program), compile to graph-native IR
    tr = models.trace_stacked("gcn", 2)
    c = compiler.compile_gnn(tr)
    print(f"IR: {c.n_layers} layers, {len(c.ir.segments)} segments, "
          f"{c.plan.max_level + 1} phases, opt report {c.opt_report}")

    # 2. reorder + sparse-tile (one-stop entry, degree sorting opted in)
    tiles, r = tiling.build_tiles(g0, 8, 8, sparse=True, reorder="degree")
    regular = tiling.grid_tile(r.graph, 8, 8, sparse=False).src_vertex_loads()
    print(f"tiles: {tiles.n_tiles} (S_max={tiles.s_max}, E_max={tiles.e_max}); "
          f"src loads {tiles.src_vertex_loads()} vs regular {regular}")

    # 3. execute on the device: the oracle and the tile interpreter
    params = models.init_params(tr)
    inputs = {k: (r.permute_vertex_features(v) if v.shape[0] == g0.n_vertices else v)
              for k, v in models.init_inputs(tr, g0).items()}
    ref = executor.run_reference(tr, r.graph, inputs, params, device=dev)[0]
    tiled = executor.run_tiled(c, r.graph, tiles, inputs, params, device=dev)[0]
    piped = pipeline.run_pipelined(c, r.graph, tiles, inputs, params, device=dev)[0]
    _sync(dev)
    t0 = time.perf_counter()
    pipeline.run_pipelined(c, r.graph, tiles, inputs, params, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    limit = TOL * max(1.0, float(ref.abs().max()))
    err_tiled = float((ref - tiled).abs().max())
    err_piped = float((ref - piped).abs().max())
    print(f"max |oracle - tiled|     = {err_tiled:.3e} (limit {limit:.1e})")
    print(f"max |oracle - pipelined| = {err_piped:.3e} (limit {limit:.1e})")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(f"run_pipelined warm pass: {wall * 1e3:.2f} ms wall-clock on {name}")
    if not (err_tiled <= limit and err_piped <= limit):
        raise AssertionError(f"engines off the oracle: tiled {err_tiled:.3e}, "
                             f"pipelined {err_piped:.3e}, limit {limit:.1e}")

    # 4. the simulator's model of the hardware: barrier vs pipelined schedule
    sde = isa.emit_sde(c.plan)
    sim = {}
    for label, hw in [("ZIPPER (paper cfg)", HWConfig()), ("TPU-v5e-like", TPU_V5E_LIKE)]:
        s = simulator.simulate_model(sde, tiles, hw)
        p = simulator.simulate_model(sde, tiles, hw, inter_layer="pipelined")
        sim[label] = dict(barrier_cycles=s.cycles, pipelined_cycles=p.cycles,
                          barrier_ms=s.time_ms, pipelined_ms=p.time_ms,
                          mu_util=s.utilization["MU"], energy_mj=s.energy_mj)
        print(f"{label:18s} (modelled by the cost model): {s.cycles} cycles = "
              f"{s.time_ms:7.2f} ms barrier, {p.cycles} = {p.time_ms:7.2f} ms pipelined "
              f"({s.cycles / p.cycles:.2f}x), MU util {s.utilization['MU']:.2f}, "
              f"energy {s.energy_mj:.1f} mJ")
    return dict(err_tiled=err_tiled, err_pipelined=err_piped, limit=limit,
                wall_s=wall, device=name, sim=sim, outputs=piped)


if __name__ == "__main__":
    main()
