"""Async serving walkthrough: continuous batching with deadlines and sheds,
the counterpart of the reference's ``examples/serve_async.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_async --requests 48 [--device cpu]

Builds on ``launch/serve_gnn.py`` (the synchronous engine) and drives the
async tier (``serve.AsyncInferenceServer``):

  1. register two tenants (gcn, gat) on one shared program cache, each
     with a cache budget and a warm-up set;
  2. start the server: the canonical size classes build in the background
     while requests are already admitted;
  3. fire a burst of single requests with deadlines; the scheduler forms
     batches per (model, size class); four sampled results a tenant are
     held against ``run_reference`` of their graph at 5e-4 x max(1, max
     |oracle|);
  4. overload a tiny second server (never started) to show structured
     ``Overloaded`` results under both shed policies;
  5. print the metrics snapshot (p50 / p99 latency, batch fill, sheds).

Latencies are the server's: wall clock from submit until a batch's
outputs are enqueued on the device, not until the device has computed
them.  Runs on
``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve
from ..gnn import graphs, models
from ..serve import AsyncInferenceServer, Overloaded
from .serve_gnn import TOL, oracle_error


def make_requests(model, n, *, v, e, seed0=0):
    """n (graph, inputs) pairs for one tenant, same size class."""
    spec = models.MODELS[model]
    tr = models.trace_named(model)
    out = []
    for k in range(n):
        g = graphs.random_graph(
            v, e, seed=seed0 + k, model="powerlaw",
            n_edge_types=spec.n_edge_types if spec.needs_etype else None)
        out.append((g, models.init_inputs(tr, g, seed=seed0 + k)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48,
                    help="requests per tenant in the main burst")
    ap.add_argument("--vertices", type=int, default=48)
    ap.add_argument("--edges", type=int, default=192)
    ap.add_argument("--deadline", type=float, default=3.0,
                    help="per-request deadline; a trailing partial batch "
                         "ships when its slack hits dispatch_margin_s, so "
                         "this also bounds the burst's tail")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    dev = resolve(args.device)

    # -- 1+2: two tenants, shared cache, background warmup ------------------
    reqs = {m: make_requests(m, args.requests, v=args.vertices, e=args.edges)
            for m in ("gcn", "gat")}
    params = {m: models.init_params(models.trace_named(m)) for m in ("gcn", "gat")}
    srv = AsyncInferenceServer(max_queue=4 * args.requests,
                               default_deadline_s=args.deadline, n_workers=2)
    for m in ("gcn", "gat"):
        srv.register_model(m, m, params[m], max_batch=16, cache_budget=8,
                           warmup_graphs=[reqs[m][0][0]], device=dev)

    results = {}
    with srv:                      # start(): scheduler + workers + warmup
        while not srv.warmup_done():
            time.sleep(0.05)
        print("warmup done:", srv.stats()["metrics"]["warmup"])

        # -- 3: a mixed burst of individual requests ------------------------
        t0 = time.perf_counter()
        tickets = [(m, k, srv.submit(g, ins, model=m))
                   for m in ("gcn", "gat") for k, (g, ins) in enumerate(reqs[m])]
        ok = 0
        for m, k, t in tickets:
            res = t.result(timeout=60.0)
            if t.ok:
                ok += 1
                results[m, k] = res
        dt = time.perf_counter() - t0
        n = len(tickets)
        last = torch.as_tensor(results[tickets[-1][0], tickets[-1][1]][0]) \
            if (tickets[-1][0], tickets[-1][1]) in results else None
        print(f"burst: {ok}/{n} served in {dt * 1e3:.0f} ms ({n / dt:.0f} req/s), "
              f"last output {None if last is None else tuple(last.shape)}")

        snap = srv.stats()["metrics"]
        print(f"latency to outputs enqueued p50/p99: "
              f"{snap['latency_s']['p50'] * 1e3:.1f}/"
              f"{snap['latency_s']['p99'] * 1e3:.1f} ms, "
              f"mean batch fill {snap['batch_fill']['mean']:.2f}, sheds {snap['shed']}")
        cache = srv.stats()["cache"]
        print("shared cache:", cache)

    err = 0.0
    for m in ("gcn", "gat"):
        tr = models.trace_named(m)
        for k in range(0, args.requests, max(1, args.requests // 4)):
            if (m, k) in results:
                g, ins = reqs[m][k]
                err = max(err, oracle_error(tr, g, ins, params[m], results[m, k], dev, m))
    print(f"sampled results vs run_reference: {err:.3e} of max(1, max|oracle|) "
          f"(limit {TOL})")

    # -- 4: overload a tiny server to show structured shedding --------------
    sheds = {}
    for policy in ("reject-new", "drop-oldest"):
        tiny = AsyncInferenceServer(max_queue=4, shed_policy=policy,
                                    default_deadline_s=args.deadline)
        tiny.register_model("gcn", "gcn", params["gcn"], max_batch=4, device=dev)
        # not started: nothing drains, so admission fills then sheds
        tix = [tiny.submit(g, ins) for g, ins in reqs["gcn"][:8]]
        tiny.close(drain=False)
        shed = [t.result() for t in tix if not t.ok]
        reasons = sorted({s.reason for s in shed if isinstance(s, Overloaded)})
        sheds[policy] = (len(shed), reasons)
        print(f"{policy:>11}: {len(shed)}/8 shed, reasons={reasons}")
    if ok != n or err > TOL:
        raise AssertionError(f"{ok}/{n} served; sampled results {err:.3e} off the oracle")
    return dict(served=ok, n=n, err=err, metrics=snap, cache=cache, sheds=sheds,
                results=results)


if __name__ == "__main__":
    main()
