"""A closed loop of whole-graph passes through a bound ``PipelinedRunner``.

Set-up makes the mix's graph from the mix's own ``graph_seed`` (one graph,
as a deployment has one dataset: a graph drawn from the run's seed changed
the tiles' padding, and so the work, by up to 28 % between seeds), the
weights and the feature sets from the run's seed, tiles the graph as the
configuration states, builds and binds the runner and runs one pass per
feature set.  The window then issues pass
after pass, each on the next feature set and each ended by a device
synchronise, until ``seconds`` have passed.  A traced run profiles
``PROFILED_PASSES`` passes a third of the way in.  The last output of each
feature set is held against the plain reference.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from gnnbench import graphgen
from gnnbench.cell import Outcome, make_params, synchronize
from gnnbench.check import rel_err
from gnnbench.trace import Profile

PROFILED_PASSES = 16


def make_data(cell, seed: int, device: torch.device, seconds: float) -> Dict:
    """The mix's graph; the weights and feature sets from the seed."""
    tr, cfg = cell.traffic, cell.config
    g = graphgen.paper_graph(tr["dataset"], tr["graph_seed"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = make_params(cell.reference.param_shapes(cfg), gen, device)
    feats = torch.randn((tr["feature_sets"], g.n_vertices, cfg["in_dim"]),
                        generator=gen, device=device)
    return dict(graph=g, params=params, feats=feats,
                src=torch.as_tensor(g.src, device=device),
                dst=torch.as_tensor(g.dst, device=device))


def check_units(data: Dict) -> List[int]:
    """The feature sets whose outputs are compared."""
    return list(range(data["feats"].shape[0]))


def reference_outputs(cell, data: Dict, units: List[int],
                      precision: str) -> Dict[int, torch.Tensor]:
    g = data["graph"]
    return {i: cell.reference.forward(data["src"], data["dst"], g.n_vertices,
                                      data["feats"][i], data["params"],
                                      cell.config, precision)
            for i in units}


def compare(cell, data: Dict, outs: Dict[int, torch.Tensor]) -> Dict[str, float]:
    want = reference_outputs(cell, data, sorted(outs), "fp32")
    return {"max_rel_err": max(rel_err(outs[i], want[i]) for i in outs)}


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device) -> Outcome:
    from repro_torch.core import compiler
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.core.tiling import build_tiles
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M

    cfg, tiling = cell.config, cell.config["whole_graph_tiling"]
    t0 = time.perf_counter()
    data = make_data(cell, seed, device, seconds)
    t_data = time.perf_counter()
    g, params = data["graph"], data["params"]
    graph = G.Graph(src=g.src, dst=g.dst, n_vertices=g.n_vertices,
                    name=cell.traffic["dataset"])
    tiles, ro = build_tiles(graph, tiling["n_dst_parts"], tiling["n_src_parts"],
                            layout=tiling["layout"])
    t_tiles = time.perf_counter()
    model = M.trace_stacked(cfg["model"], cfg["layers"], cfg["in_dim"],
                            cfg["hidden_dim"], cfg["out_dim"])
    if dict(model.params) != cell.reference.param_shapes(cfg):
        raise ValueError(f"the program's parameters {dict(model.params)} are "
                         "not the reference's")
    held = {"runner": PipelinedRunner(
        compiler.compile_gnn(model), ro.graph, tiles,
        kernel_dispatch=cfg["kernel_dispatch"], reordering=ro, device=device)}
    inputs = [cell.reference.program_inputs(data["src"], data["dst"],
                                            g.n_vertices, x)
              for x in data["feats"]]
    n_sets = len(inputs)
    keep: Dict[int, torch.Tensor] = {}
    prof = Profile(device) if trace else None
    state, p0, t_prof = 0, 0, 0.0           # 0 before, 1 during, 2 after
    t_runner = time.perf_counter()
    with torch.inference_mode():
        for x in inputs:                    # binds, and warms every shape
            held["runner"](x, params)
        synchronize(device)
        n = 0
        t_start = time.perf_counter()
        while True:
            if prof is not None and state == 0 \
                    and time.perf_counter() - t_start >= seconds / 3:
                t_prof = time.perf_counter()
                prof.start()
                p0, state = n, 1
            out = held["runner"](inputs[n % n_sets], params)[0]
            synchronize(device)
            keep[n % n_sets] = out
            n += 1
            if state == 1 and n - p0 == PROFILED_PASSES:
                prof.stop()
                t_prof = time.perf_counter() - t_prof
                state = 2
            if time.perf_counter() - t_start >= seconds and state != 1 \
                    and (prof is None or state == 2):
                break
        t_end = time.perf_counter()
    window = t_end - t_start
    reading = dict(model=cfg["model"], layers=cfg["layers"], F=cfg["hidden_dim"],
                   units=PROFILED_PASSES, profile=prof,
                   graphs=[(g.n_vertices, g.n_edges, PROFILED_PASSES)],
                   passes=n - (PROFILED_PASSES if prof else 0),
                   passes_s=window - (t_prof if prof else 0.0))
    return Outcome(window_start=t_start, attempted=n, failed=0,
                   metrics={"pass_ms": 1e3 * window / n}, reading=reading,
                   release=held.clear,
                   check=lambda: compare(cell, data, keep),
                   notes=dict(passes=n, window_s=window,
                              tiles=tiles.n_tiles, s_max=tiles.s_max,
                              setup_steps_s=dict(data=t_data - t0,
                                                 tiling=t_tiles - t_data,
                                                 runner=t_runner - t_tiles,
                                                 bind_and_warm=t_start - t_runner)))
