"""Serve a stream of small graphs through the batched inference engine:
the counterpart of the reference's ``examples/serve_gnn.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --model gcn --requests 6 --batch 16 [--device cpu]

Each request's batch of small graphs is merged into one block-diagonal
graph, padded onto a size class and run by a cached runner
(``serve.InferenceServer``): one build per structure, reused by every
request of the stream.  Prints the first (cold, building) request's latency
against the warm ones and the program-cache counters, and holds every graph
of the last request against the whole-graph oracle ``run_reference`` at 5e-4
x max(1, max |oracle|) (sage on vertices with in-edges: ROADMAP C.1).
Latencies are wall-clock on the device the engine runs on.  Runs on
``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import compiler, executor
from ..device import resolve
from ..gnn import graphs, models
from ..serve import InferenceServer

TOL = 5e-4


def oracle_error(tr, g, inputs, params, out, dev, model: str) -> float:
    """max |served - run_reference| over a graph's outputs, relative to
    max(1, max |oracle|); sage only on vertices with in-edges (ROADMAP
    C.1: the reference clamps empty neighbourhoods to -1e30)."""
    ref = executor.run_reference(tr, g, inputs, params, device=dev)
    worst = 0.0
    for r, o in zip(ref, out):
        r, o = r.float(), torch.as_tensor(o, device=dev).float()
        if model == "sage" and r.shape[0] == g.n_vertices:
            keep = torch.as_tensor(g.in_degrees() > 0, device=dev)
            r, o = r[keep], o[keep]
        worst = max(worst, float((r - o).abs().max()) / max(1.0, float(r.abs().max())))
    return worst


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gcn", choices=sorted(models.MODELS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vertices", type=int, default=64)
    ap.add_argument("--edges", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.requests < 1 or args.batch < 1:
        ap.error("--requests and --batch must be >= 1")
    dev = resolve(args.device)

    spec = models.MODELS[args.model]
    tr = models.trace_named(args.model)
    compiled = compiler.compile_gnn(tr)
    params = models.init_params(tr)
    server = InferenceServer(compiled, params, device=dev)

    print(f"serving {args.model}: {args.requests} requests x "
          f"{args.batch} graphs (~{args.vertices}V/{args.edges}E each) on {dev}")
    latency = []
    for req in range(args.requests):
        gs, ins = [], []
        for k in range(args.batch):
            seed = req * 1000 + k
            g = graphs.random_graph(
                args.vertices, args.edges, seed=seed, model="powerlaw",
                n_edge_types=spec.n_edge_types if spec.needs_etype else None)
            gs.append(g)
            ins.append(models.init_inputs(tr, g, seed=seed))
        t0 = time.perf_counter()
        outs = server.submit(gs, ins)
        dt = time.perf_counter() - t0
        latency.append(dt)
        tag = "cold (building)" if req == 0 else "warm (cache hit)"
        print(f"  request {req}: {args.batch} graphs in {dt * 1e3:7.1f} ms "
              f"({args.batch / dt:8.1f} g/s)  {tag}")

    # per-graph vertex outputs come back exactly sliced; pool one for show
    last = torch.as_tensor(outs[0][0])
    print(f"graph 0 output: {tuple(last.shape)}, mean readout {float(last.float().mean()):+.4f}")
    err = max(oracle_error(tr, g, i, params, o, dev, args.model)
              for g, i, o in zip(gs, ins, outs))
    print(f"last request vs run_reference: {err:.3e} of max(1, max|oracle|) (limit {TOL})")
    stats = server.stats()
    print("server stats:", stats)
    if err > TOL:
        raise AssertionError(f"served outputs off the oracle: {err:.3e} > {TOL}")
    return dict(latency_s=latency, err=err, stats=stats, outputs=outs)


if __name__ == "__main__":
    main()
