"""A closed loop of whole-graph passes of a relational model (R-GCN as
published) through a bound ``PipelinedRunner``.

Set-up makes the mix's graph from its ``graph_seed`` and each edge's
relation from its ``relation_seed`` (a Zipf law over the mix's relations:
one graph and one labelling, as a deployment has one knowledge graph), the
weights (the published bases, coefficients and self-connections) and the
feature sets from the run's seed.  The program adds the inverse edges and
the normalisation itself (``repro_torch.gnn.relational``), tiles the graph
as the configuration states, builds and binds the runner and runs one pass
per feature set.  A pass is the basis combination and the tiled program.
The window then issues pass after pass, each on the next feature set and
each ended by a device synchronise, until ``seconds`` have passed.  A
traced run profiles ``PROFILED_PASSES`` passes a third of the way in.  The
last output of each feature set is held against the plain reference, which
makes its own inverse edges and normalisation from the canonical ones.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from gnnbench import graphgen
from gnnbench.cell import HERE, Outcome, import_file, make_params, synchronize
from gnnbench.check import rel_err
from gnnbench.trace import Profile

PROFILED_PASSES = import_file(HERE / "drivers" / "whole_graph.py").PROFILED_PASSES


def relations(n_edges: int, tr: Dict) -> np.ndarray:
    """(E,) int32: each canonical edge's relation, drawn from the mix's
    Zipf law over its relations with its frozen ``relation_seed``."""
    p = 1.0 / np.arange(1, tr["relations"] + 1) ** tr["relation_zipf"]
    rng = np.random.default_rng(tr["relation_seed"])
    return rng.choice(tr["relations"], size=n_edges, p=p / p.sum()).astype(np.int32)


def make_data(cell, seed: int, device: torch.device, seconds: float) -> Dict:
    """The mix's typed graph; the weights and feature sets from the seed."""
    tr, cfg = cell.traffic, cell.config
    if 2 * tr["relations"] != cfg["relations"]:
        raise ValueError(f"the mix's {tr['relations']} relations and their "
                         f"inverses are not the configuration's {cfg['relations']}")
    g = graphgen.paper_graph(tr["dataset"], tr["graph_seed"])
    rel = relations(g.n_edges, tr)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = make_params(cell.reference.param_shapes(cfg), gen, device)
    feats = torch.randn((tr["feature_sets"], g.n_vertices, cfg["in_dim"]),
                        generator=gen, device=device)
    return dict(graph=g, rel=rel, params=params, feats=feats,
                src=torch.as_tensor(g.src, device=device),
                dst=torch.as_tensor(g.dst, device=device),
                rel_t=torch.as_tensor(rel, device=device))


def check_units(data: Dict) -> List[int]:
    """The feature sets whose outputs are compared."""
    return list(range(data["feats"].shape[0]))


def reference_outputs(cell, data: Dict, units: List[int],
                      precision: str) -> Dict[int, torch.Tensor]:
    g = data["graph"]
    return {i: cell.reference.forward(data["src"], data["dst"], data["rel_t"],
                                      g.n_vertices, data["feats"][i],
                                      data["params"], cell.config, precision)
            for i in units}


def compare(cell, data: Dict, outs: Dict[int, torch.Tensor]) -> Dict[str, float]:
    want = reference_outputs(cell, data, sorted(outs), "fp32")
    return {"max_rel_err": max(rel_err(outs[i], want[i]) for i in outs)}


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device) -> Outcome:
    from repro_torch.gnn import relational as RL   # first: a program without it fails at once
    from repro_torch.core import compiler
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.core.tiling import build_tiles

    cfg, tiling = cell.config, cell.config["whole_graph_tiling"]
    t0 = time.perf_counter()
    data = make_data(cell, seed, device, seconds)
    t_data = time.perf_counter()
    g, params = data["graph"], data["params"]
    graph, edge_inputs = RL.relational_graph(g.src, g.dst, data["rel"], g.n_vertices,
                                             cfg["relations"], name=cell.traffic["dataset"])
    tiles, ro = build_tiles(graph, tiling["n_dst_parts"], tiling["n_src_parts"],
                            layout=tiling["layout"])
    t_tiles = time.perf_counter()
    model = RL.trace_rgcn(cfg["layers"], cfg["in_dim"], cfg["hidden_dim"],
                          cfg["out_dim"], cfg["relations"])
    combined = {k: tuple(v.shape) for k, v in RL.combine_bases(params).items()}
    if combined != dict(model.params):
        raise ValueError(f"the program's parameters {dict(model.params)} are not "
                         f"the reference's, combined: {combined}")
    held = {"runner": PipelinedRunner(
        compiler.compile_gnn(model), ro.graph, tiles,
        kernel_dispatch=cfg["kernel_dispatch"], reordering=ro, device=device)}
    edge_inputs = {k: torch.as_tensor(v, device=device) for k, v in edge_inputs.items()}
    inputs = [dict(edge_inputs, x=x) for x in data["feats"]]
    n_sets = len(inputs)
    keep: Dict[int, torch.Tensor] = {}
    prof = Profile(device) if trace else None
    state, p0, t_prof = 0, 0, 0.0           # 0 before, 1 during, 2 after
    t_runner = time.perf_counter()
    with torch.inference_mode():
        for x in inputs:                    # binds, and warms every shape
            RL.run(held["runner"], x, params)
        synchronize(device)
        n = 0
        t_start = time.perf_counter()
        ends = [t_start]                    # each pass's end, for its spread
        while True:
            if prof is not None and state == 0 \
                    and time.perf_counter() - t_start >= seconds / 3:
                t_prof = time.perf_counter()
                prof.start()
                p0, state = n, 1
            out = RL.run(held["runner"], inputs[n % n_sets], params)[0]
            synchronize(device)
            ends.append(time.perf_counter())
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
                   relations=cfg["relations"], bases=cfg["bases"],
                   units=PROFILED_PASSES, profile=prof,
                   graphs=[(graph.n_vertices, graph.n_edges, PROFILED_PASSES)],
                   passes=n - (PROFILED_PASSES if prof else 0),
                   passes_s=window - (t_prof if prof else 0.0))
    return Outcome(window_start=t_start, attempted=n, failed=0,
                   metrics={"pass_ms": 1e3 * window / n}, reading=reading,
                   release=held.clear,
                   check=lambda: compare(cell, data, keep),
                   notes=dict(passes=n, window_s=window, messages=graph.n_edges,
                              pass_ms_quartiles=statistics.quantiles(
                                  [1e3 * (b - a) for a, b in zip(ends, ends[1:])], n=4)
                              if n > 1 else None,
                              tiles=tiles.n_tiles, s_max=tiles.s_max,
                              e_max=tiles.e_max,
                              setup_steps_s=dict(data=t_data - t0,
                                                 tiling=t_tiles - t_data,
                                                 runner=t_runner - t_tiles,
                                                 bind_and_warm=t_start - t_runner)))
