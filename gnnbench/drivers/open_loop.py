"""An open loop of single-graph requests into ``AsyncInferenceServer``.

The mix fixes the rate for each configuration, the graph the requests are
sampled from, the seeds a request names, the fan-outs, the feature pool
and the server's settings.  A run of ``seconds`` sends ``rate x seconds``
requests.  Every seed sends the same requests (each the sampled 2-hop
neighbourhood of its seed vertices, drawn from the mix's ``graph_seed``)
and the same gaps between arrivals (exponential quantiles at the rate, so
the arrivals are Poisson-like), each in its own seeded order; the features
and the weights are drawn from the seed.

Set-up registers the model, warms every size class through the server's
own warm-up and through one batch of each class's largest graphs.  The
window submits each request when it is due.  A collector thread for each
size class, the key the server batches by, blocks on that class's tickets
in the order they were submitted, takes each output's rows to the host
and stamps the time as soon as its own copy is done.  A request's latency
runs from when it was due until its rows are on the host; one that is shed
or fails counts as missing, at the longest wait.  The served rate is the
requests served over the time from the window's start until the last of
them is on the host.  A traced run profiles
the whole window; the profiler starts in set-up, so its own start-up
stalls no arrival.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from gnnbench import graphgen
from gnnbench.cell import Outcome, make_params, synchronize
from gnnbench.check import nearest_rank, rel_err
from gnnbench.trace import Profile

WAIT_S = 60.0            # how long past the last arrival a request is awaited
BLOCK_EDGES = 4 << 20    # edges of one block of the reference


def schedule(n_requests: int, rate: float, rng: np.random.Generator):
    """(arrival order, due times): the same gaps for every seed, in the
    seed's order; the requests in the seed's order."""
    n = n_requests
    gaps = -np.log1p(-(np.arange(n - 1) + 0.5) / max(n - 1, 1)) / rate
    rng.shuffle(gaps)
    return rng.permutation(n), np.concatenate([[0.0], np.cumsum(gaps)])


def requests(tr: Dict, n: int, device: torch.device) -> List[graphgen.Arrays]:
    """The mix's ``n`` requests, drawn from its ``graph_seed`` alone."""
    g = graphgen.paper_graph(tr["dataset"], tr["graph_seed"])
    indptr, nbrs = graphgen.undirected_csr(g, device)
    lo, hi = tr["seeds_per_request"]
    k = np.random.default_rng(tr["graph_seed"]).integers(lo, hi + 1, n)
    gen = torch.Generator(device=device)
    gen.manual_seed(tr["graph_seed"])
    return graphgen.sample_neighbourhoods(indptr, nbrs, k, tr["fanouts"], gen)


def make_data(cell, seed: int, device: torch.device, seconds: float) -> Dict:
    """The mix's requests in the seed's order; weights and features from
    the seed."""
    tr, cfg = cell.traffic, cell.config
    rng = np.random.default_rng(seed)
    rate = tr["rate_per_s"][cell.config_name]
    n = max(1, int(round(rate * seconds)))
    made = requests(tr, n, device)
    order, due = schedule(n, rate, rng)
    graphs = [made[i] for i in order]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = make_params(cell.reference.param_shapes(cfg), gen, device)
    top = max(g.n_vertices for g in graphs)
    pool = torch.randn((tr["feature_pool"], top, cfg["in_dim"]), generator=gen,
                       device=device)
    pick = rng.integers(0, tr["feature_pool"], n)
    sample = rng.choice(n, size=min(n, tr["check_sample"]), replace=False)
    largest = np.argsort([-g.n_edges for g in graphs], kind="stable")
    sample = sorted(set(sample.tolist()) | set(largest[:tr["check_largest"]].tolist()))
    return dict(graphs=graphs, due=due, params=params, pool=pool, pick=pick,
                sample=sample)


def check_units(data: Dict) -> List[int]:
    """The requests whose outputs are compared."""
    return data["sample"]


def reference_outputs(cell, data: Dict, units: List[int],
                      precision: str) -> Dict[int, torch.Tensor]:
    """The reference over the requests ``units``, merged into
    block-diagonal graphs of at most ``BLOCK_EDGES`` edges."""
    pool, dev = data["pool"], data["pool"].device
    out: Dict[int, torch.Tensor] = {}
    block: List[int] = []

    def flush():
        gs = [data["graphs"][i] for i in block]
        v_off = np.concatenate([[0], np.cumsum([g.n_vertices for g in gs])])
        src = torch.as_tensor(np.concatenate(
            [g.src.astype(np.int64) + o for g, o in zip(gs, v_off)]), device=dev)
        dst = torch.as_tensor(np.concatenate(
            [g.dst.astype(np.int64) + o for g, o in zip(gs, v_off)]), device=dev)
        x = torch.cat([pool[data["pick"][i], :g.n_vertices] for i, g in zip(block, gs)])
        y = cell.reference.forward(src, dst, int(v_off[-1]), x, data["params"],
                                   cell.config, precision)
        for k, i in enumerate(block):
            out[i] = y[v_off[k]:v_off[k + 1]]
        block.clear()

    edges = 0
    for i in units:
        e = data["graphs"][i].n_edges
        if block and edges + e > BLOCK_EDGES:
            flush()
            edges = 0
        block.append(i)
        edges += e
    if block:
        flush()
    return out


def compare(cell, data: Dict, outs: Dict[int, torch.Tensor],
            lost: int = 0) -> Dict[str, float]:
    want = reference_outputs(cell, data, sorted(outs), "fp32")
    errs = [rel_err(outs[i], want[i]) for i in outs]
    return {"max_rel_err": max(errs, default=0.0), "lost_requests": float(lost)}


class Collector:
    """One thread for each size class.  Each blocks on its class's tickets
    in the order they were submitted, takes each resolved output's rows to
    the host and stamps the time once that copy is done.  A ticket that a
    later batch of its class resolves first waits for its predecessors,
    whose work runs before its own on the one stream."""

    def __init__(self, classes, n: int, keep: set, give_up: float):
        self.queues = {c: queue.SimpleQueue() for c in classes}
        self.done_at = np.full(n, np.nan)
        self.ok = np.zeros(n, bool)
        self.errors: List[str] = []
        self.keep, self.outs = keep, {}
        self.give_up = give_up
        self.threads = [threading.Thread(target=self._drain, args=(q,), daemon=True,
                                         name="gnnbench-collector")
                        for q in self.queues.values()]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def add(self, cls, i: int, ticket) -> None:
        self.queues[cls].put((i, ticket))

    def close(self, timeout: float) -> None:
        for q in self.queues.values():
            q.put(None)
        for t in self.threads:
            t.join(max(0.0, self.give_up + timeout - time.perf_counter()))

    def _drain(self, q: queue.SimpleQueue) -> None:
        while (item := q.get()) is not None:
            i, t = item
            if not t.wait(max(0.0, self.give_up - time.perf_counter())):
                continue                        # never resolved: lost
            if t.ok:
                rows = t.result(0)[0].cpu()
                self.done_at[i] = time.perf_counter()
                self.ok[i] = True
                if i in self.keep:
                    self.outs[i] = rows
            else:
                self.done_at[i] = time.perf_counter()
                try:
                    t.result(0)
                except Exception as exc:        # the request failed
                    self.errors.append(f"request {i}: {exc!r}")


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device) -> Outcome:
    from repro_torch.core import compiler
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.serve import AsyncInferenceServer
    from repro_torch.serve.signature import size_class

    tr, cfg = cell.traffic, cell.config
    t0 = time.perf_counter()
    data = make_data(cell, seed, device, seconds)
    t_data = time.perf_counter()
    ref = cell.reference
    model = M.trace_stacked(cfg["model"], cfg["layers"], cfg["in_dim"],
                            cfg["hidden_dim"], cfg["out_dim"])
    if dict(model.params) != ref.param_shapes(cfg):
        raise ValueError(f"the program's parameters {dict(model.params)} are "
                         "not the reference's")
    pool = data["pool"].cpu()
    graphs, inputs = [], []
    for arr, k in zip(data["graphs"], data["pick"]):
        x = pool[k, :arr.n_vertices]
        src, dst = torch.from_numpy(arr.src), torch.from_numpy(arr.dst)
        inputs.append({name: v.numpy() for name, v in
                       ref.program_inputs(src, dst, arr.n_vertices, x).items()})
        graphs.append(G.Graph(src=arr.src, dst=arr.dst, n_vertices=arr.n_vertices))
    n, due = len(graphs), data["due"]
    cls = [size_class(g) for g in graphs]
    classes: Dict[tuple, List[int]] = {}
    for i, c in enumerate(cls):
        classes.setdefault(c, []).append(i)
    by_size = {c: sorted(idx, key=lambda i: -graphs[i].n_edges)
               for c, idx in classes.items()}

    t_requests = time.perf_counter()
    srv = AsyncInferenceServer(**tr["server"])
    name = cfg["model"]
    engine = srv.register_model(
        name, compiler.compile_gnn(model), data["params"],
        max_batch=tr["max_batch"], warmup_graphs=[graphs[b[0]] for b in by_size.values()],
        kernel_dispatch=cfg["kernel_dispatch"], device=device)
    try:
        srv.start()
        while not srv.warmup_done():
            if time.perf_counter() - t_requests > 600:
                raise RuntimeError("the server's warm-up took over 600 s")
            time.sleep(0.01)
        t_warm = time.perf_counter()
        if srv.metrics.snapshot()["shed"].get("warmup-failed", 0):
            raise RuntimeError("a warm-up batch of the server failed")
        for big in by_size.values():        # a batch of distinct large graphs
            take = (big[:tr["max_batch"]] * tr["max_batch"])[:tr["max_batch"]]
            engine.submit([graphs[i] for i in take], [inputs[i] for i in take])
        synchronize(device)
        builds0 = engine.compile_count
        prof = Profile(device) if trace else None
        if prof is not None:
            prof.start()
        lateness = np.zeros(n)
        t_start = time.perf_counter()
        col = Collector(classes, n, set(data["sample"]), t_start + due[-1] + WAIT_S)
        col.start()
        for i in range(n):
            target = t_start + due[i]
            while (wait := target - time.perf_counter()) > 0:
                time.sleep(wait)
            lateness[i] = time.perf_counter() - target
            col.add(cls[i], i, srv.submit(graphs[i], inputs[i], model=name))
        col.close(60.0)
        if prof is not None:
            prof.stop()
        t_end = time.perf_counter()
        snap = srv.metrics.snapshot()
        builds = engine.compile_count - builds0
    finally:
        srv.close(timeout=WAIT_S)
    done_at = col.done_at
    lost = int(np.isnan(done_at).sum()) + len(col.errors)
    missing_s = due[-1] + WAIT_S
    lat = np.where(col.ok, done_at - (t_start + due), missing_s)
    ok = np.flatnonzero(col.ok)
    p95_ms = nearest_rank((1e3 * lat).tolist(), 95)
    served_per_s = len(ok) / (np.max(done_at[ok]) - t_start) if len(ok) else 0.0
    last = t_start + due[-1]
    quarter = max(1, n // 4)            # requests are numbered by due time
    reading = dict(model=cfg["model"], layers=cfg["layers"], F=cfg["hidden_dim"],
                   units=len(ok), profile=prof,
                   graphs=[(graphs[i].n_vertices, graphs[i].n_edges, 1) for i in ok],
                   latencies_s=lat[ok].tolist(), p95_ms=p95_ms,
                   serve=snap, builds=builds)
    notes = dict(
        requests=n, served=len(ok), shed=snap["shed"], errors=col.errors[:3],
        p50_ms=nearest_rank((1e3 * lat).tolist(), 50), p95_ms=p95_ms,
        served_per_s=served_per_s,
        size_classes=len(classes),
        lateness_ms=dict(p50=1e3 * float(np.median(lateness)),
                         p99=1e3 * nearest_rank(lateness.tolist(), 99),
                         max=1e3 * float(lateness.max())),
        # backlog: requests still open when the last one arrived, and the
        # median latency of the last quarter of arrivals over the first's
        open_at_last_arrival=int(((done_at > last) | np.isnan(done_at)).sum()),
        latency_trend=float(np.median(lat[-quarter:]) / np.median(lat[:quarter])),
        drain_s=t_end - last,
        setup_steps_s=dict(data=t_data - t0, requests=t_requests - t_data,
                           server_warmup=t_warm - t_requests,
                           warm_batches=t_start - t_warm))
    return Outcome(window_start=t_start, attempted=n, failed=n - len(ok),
                   metrics={"p95_ms": p95_ms, "served_per_s": served_per_s},
                   reading=reading, release=lambda: None,
                   check=lambda: compare(cell, data, col.outs, lost),
                   notes=notes)
