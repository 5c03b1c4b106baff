"""The port's async serving tier (`repro_torch.serve.server`, a copy of the
reference's over the port's `InferenceServer`) on `device="cpu"`: the cases
of `tests/test_serve_async.py` — results against `repro`'s whole-graph
oracle, deadlines, both shed policies, the warm-up race, drain, tenant
budgets and the metrics layer.  Every `result()` and `close()` is bounded
by a timeout, so no case can hang."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jexecutor
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro_torch.core import compiler as tcompiler
from repro_torch.gnn import models as tmodels
from repro_torch.serve import (AsyncInferenceServer, Overloaded, ProgramCache,
                               ServeMetrics)
from repro_torch.serve.metrics import Histogram, percentile
from repro_torch.serve.server import (DEADLINE_EXPIRED, DROPPED_OLDEST,
                                      QUEUE_FULL, SHUTDOWN)

TOL = 5e-4
DIM = 8
CLOSE_S = 60        # bound on every close(): the scheduler's join


def _compiled(name="gcn", n_layers=1, dim=DIM):
    if n_layers == 1:
        jtr, ttr = jmodels.trace_named(name, dim, dim), tmodels.trace_named(name, dim, dim)
    else:
        jtr = jmodels.trace_stacked(name, n_layers, dim, dim, dim)
        ttr = tmodels.trace_stacked(name, n_layers, dim, dim, dim)
    return jtr, tcompiler.compile_gnn(ttr)


def _stream(tr, n, v=32, e=120, seed0=0):
    gs = [jgraphs.random_graph(v, e, seed=seed0 + k, model="powerlaw")
          for k in range(n)]
    ins = [jmodels.init_inputs(tr, g, seed=seed0 + k) for k, g in enumerate(gs)]
    return gs, ins


def _server(**kw):
    kw.setdefault("default_deadline_s", 30.0)
    kw.setdefault("dispatch_margin_s", 0.05)
    kw.setdefault("n_workers", 2)
    return AsyncInferenceServer(**kw)


def _oracle_err(tr, g, inp, params, out):
    ref = np.asarray(jexecutor.run_reference(tr, g, inp, params)[0])
    return float(np.max(np.abs(ref - out[0].numpy())))


# ---------------------------------------------------------------------------
# request lifecycle: submit -> batch -> oracle-exact results
# ---------------------------------------------------------------------------

def test_async_results_match_oracle_and_ticket_api():
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    srv = _server().start()
    try:
        engine = srv.register_model("gcn", c, params, max_batch=4, device="cpu")
        assert engine.device == torch.device("cpu")
        gs, ins = _stream(tr, 6)
        # 4 fill a batch; the other 2 ship when their 2 s slack runs out
        tickets = srv.submit_many(gs, ins, deadline_s=2.0)
        outs = [t.result(timeout=60) for t in tickets]
        for t in tickets:
            assert t.done() and t.ok
        for g, inp, out in zip(gs, ins, outs):
            assert out[0].device.type == "cpu"
            assert _oracle_err(tr, g, inp, params, out) < TOL
        snap = srv.metrics.snapshot()
        assert snap["completed"] == 6 and snap["shed_total"] == 0
        assert snap["latency_s"]["count"] == 6
    finally:
        srv.close(timeout=CLOSE_S)
    assert not srv._scheduler.is_alive()
    # a closed server sheds late submits structurally
    late = srv.submit(gs[0], ins[0])
    res = late.result(timeout=5)
    assert isinstance(res, Overloaded) and res.reason == SHUTDOWN


def test_engines_run_on_cuda_unless_told_otherwise():
    """With no card visible, a tenant registered without ``device`` raises
    instead of quietly serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    tr, c = _compiled()
    srv = _server()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.register_model("gcn", c, jmodels.init_params(tr))
    srv.close(timeout=CLOSE_S)


def test_model_routing_errors():
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    srv = _server()
    with pytest.raises(ValueError):          # nothing registered
        srv.submit(jgraphs.random_graph(8, 16, seed=0), {})
    srv.register_model("a", c, params, device="cpu")
    srv.register_model("b", c, params, device="cpu")
    with pytest.raises(KeyError):
        srv.submit(jgraphs.random_graph(8, 16, seed=0), {}, model="nope")
    with pytest.raises(ValueError):          # ambiguous default
        srv.submit(jgraphs.random_graph(8, 16, seed=0), {})
    with pytest.raises(ValueError):          # duplicate tenant
        srv.register_model("a", c, params, device="cpu")
    srv.close(timeout=CLOSE_S)


# ---------------------------------------------------------------------------
# deadline edge cases
# ---------------------------------------------------------------------------

def test_already_expired_deadline_sheds_immediately():
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    srv = _server()
    srv.register_model("gcn", c, params, device="cpu")
    g, = _stream(tr, 1)[0]
    t = srv.submit(g, {}, deadline_s=0.0)     # asked for an answer in the past
    assert t.done()                           # resolved without the scheduler
    res = t.result(timeout=5)
    assert isinstance(res, Overloaded) and res.reason == DEADLINE_EXPIRED
    assert not t.ok
    assert srv.metrics.snapshot()["shed"][DEADLINE_EXPIRED] == 1
    assert srv.queue_depth == 0
    srv.close(timeout=CLOSE_S)


def test_partial_batch_ships_when_slack_expires():
    """3 requests against a cap of 8: nothing fills the batch, so the
    deadline must ship it — well before the full deadline elapses."""
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    srv = _server(dispatch_margin_s=0.2).start()
    try:
        srv.register_model("gcn", c, params, max_batch=8, device="cpu")
        gs, ins = _stream(tr, 3)
        t0 = time.monotonic()
        tickets = srv.submit_many(gs, ins, deadline_s=1.0)
        outs = [t.result(timeout=30) for t in tickets]
        took = time.monotonic() - t0
        assert all(t.ok for t in tickets)
        for g, inp, out in zip(gs, ins, outs):
            assert _oracle_err(tr, g, inp, params, out) < TOL
        snap = srv.metrics.snapshot()
        assert snap["batches"] == 1                      # one partial batch
        assert snap["batch_fill"]["max"] == pytest.approx(3 / 8)
        assert took < 30, "partial batch never shipped"
    finally:
        srv.close(timeout=CLOSE_S)


# ---------------------------------------------------------------------------
# admission control: queue-full shed under both policies
# ---------------------------------------------------------------------------

def test_queue_full_reject_new():
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    # not started: nothing drains the queue, so the bound is hit exactly
    srv = _server(max_queue=2, shed_policy="reject-new")
    srv.register_model("gcn", c, params, device="cpu")
    gs, ins = _stream(tr, 3)
    t1 = srv.submit(gs[0], ins[0])
    t2 = srv.submit(gs[1], ins[1])
    t3 = srv.submit(gs[2], ins[2])
    assert not t1.done() and not t2.done()
    res = t3.result(timeout=5)
    assert isinstance(res, Overloaded) and res.reason == QUEUE_FULL
    assert res.queue_depth == 2 and res.model == "gcn"
    assert srv.queue_depth == 2
    srv.close(timeout=CLOSE_S)                   # unstarted close drains
    assert isinstance(t1.result(timeout=5), Overloaded)
    assert t1.result(timeout=5).reason == SHUTDOWN


def test_queue_full_drop_oldest():
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    srv = _server(max_queue=2, shed_policy="drop-oldest")
    srv.register_model("gcn", c, params, device="cpu")
    gs, ins = _stream(tr, 3)
    t1 = srv.submit(gs[0], ins[0])
    t2 = srv.submit(gs[1], ins[1])
    t3 = srv.submit(gs[2], ins[2])
    res = t1.result(timeout=5)                   # the OLDEST was evicted
    assert isinstance(res, Overloaded) and res.reason == DROPPED_OLDEST
    assert not t2.done() and not t3.done()       # newcomer was admitted
    assert srv.queue_depth == 2
    assert srv.metrics.snapshot()["shed"] == {DROPPED_OLDEST: 1}
    srv.close(drain=False, timeout=CLOSE_S)
    assert t2.result(timeout=5).reason == SHUTDOWN
    assert t3.result(timeout=5).reason == SHUTDOWN


# ---------------------------------------------------------------------------
# warmup racing a real request for the same size class
# ---------------------------------------------------------------------------

def test_warmup_races_real_request_single_build():
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    warm_g = jgraphs.random_graph(32, 120, seed=777, model="powerlaw")
    srv = _server()
    engine = srv.register_model("gcn", c, params, max_batch=4,
                                warmup_graphs=[warm_g], device="cpu")
    srv.start()                                   # warmup build kicks off
    try:
        gs, ins = _stream(tr, 4)                  # same size class, right now
        tickets = srv.submit_many(gs, ins)
        for t in tickets:
            assert t.result(timeout=120) is not None and t.ok
        deadline = time.monotonic() + 60
        while not srv.warmup_done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.warmup_done()
        # the race resolved inside the cache: one build, everyone else waited
        assert engine.compile_count == 1, \
            f"warmup raced a duplicate build ({engine.compile_count})"
        assert srv.cache.stats.hits >= 1
        assert srv.metrics.snapshot()["warmup"] == dict(done=1, total=1)
    finally:
        srv.close(timeout=CLOSE_S)


def test_concurrent_same_key_builds_once():
    """ProgramCache per-key build lock: N threads racing one key invoke the
    builder once; losers block and come back as hits."""
    cache = ProgramCache(capacity=4)
    built = []

    def build():
        time.sleep(0.05)                  # widen the race window
        built.append(1)
        return "value"

    results = []
    threads = [threading.Thread(
        target=lambda: results.append(cache.get_or_build("k", build)))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert built == [1] and results == ["value"] * 4
    assert cache.stats.misses == 1 and cache.stats.hits == 3


# ---------------------------------------------------------------------------
# graceful shutdown
# ---------------------------------------------------------------------------

def test_zero_request_graceful_shutdown():
    """A started server that never saw a request closes promptly and its
    scheduler thread exits."""
    tr, c = _compiled()
    srv = _server()
    srv.register_model("gcn", c, jmodels.init_params(tr), device="cpu")
    srv.start(warmup=False)
    t0 = time.monotonic()
    srv.close(drain=True, timeout=CLOSE_S)
    assert time.monotonic() - t0 < 10
    assert not srv._scheduler.is_alive()
    srv.close(timeout=CLOSE_S)                    # idempotent


def test_close_drains_pending_requests():
    """close(drain=True) serves what is already queued (partial batch, far
    deadline) instead of abandoning it."""
    tr, c = _compiled()
    params = jmodels.init_params(tr)
    srv = _server(n_workers=1, dispatch_margin_s=0.05)
    srv.register_model("gcn", c, params, max_batch=8, device="cpu")
    srv.start(warmup=False)
    gs, ins = _stream(tr, 2)
    tickets = srv.submit_many(gs, ins, deadline_s=300.0)   # never ripe
    srv.close(drain=True, timeout=CLOSE_S)
    assert not srv._scheduler.is_alive()
    for t, g, inp in zip(tickets, gs, ins):
        out = t.result(timeout=5)
        assert t.ok, out
        assert _oracle_err(tr, g, inp, params, out) < TOL


# ---------------------------------------------------------------------------
# multi-tenancy: shared cache, per-owner budgets
# ---------------------------------------------------------------------------

def test_multi_tenant_budgets_evict_within_owner_only():
    tr_a, c_a = _compiled("gcn")
    tr_b, c_b = _compiled("gcn", n_layers=2)
    srv = _server()
    eng_a = srv.register_model("tenant-a", c_a, jmodels.init_params(tr_a),
                               cache_budget=1, device="cpu")
    eng_b = srv.register_model("tenant-b", c_b, jmodels.init_params(tr_b),
                               cache_budget=2, device="cpu")
    # drive the engines synchronously: two size classes per tenant
    small_g, small_i = _stream(tr_a, 2, v=24, e=80)
    big_g, big_i = _stream(tr_a, 2, v=200, e=900, seed0=9)
    eng_a.submit(small_g, small_i)
    eng_b.submit(small_g, small_i)
    eng_b.submit(big_g, big_i)
    assert srv.cache.owner_counts() == {"tenant-a": 1, "tenant-b": 2}
    # tenant-a overflowing its budget of 1 evicts ITS entry, not b's
    evictions_before = srv.cache.stats.evictions
    eng_a.submit(big_g, big_i)
    assert srv.cache.owner_counts() == {"tenant-a": 1, "tenant-b": 2}
    assert srv.cache.stats.evictions == evictions_before + 1
    # b's built runners survived: same-class resubmission is a pure hit
    compiles = srv.cache.stats.compiles
    eng_b.submit(small_g, small_i)
    eng_b.submit(big_g, big_i)
    assert srv.cache.stats.compiles == compiles
    srv.close(timeout=CLOSE_S)


def test_cache_budget_validation():
    cache = ProgramCache(capacity=4)
    with pytest.raises(ValueError):
        cache.set_budget("x", 0)
    with pytest.raises(ValueError):
        AsyncInferenceServer(shed_policy="lifo")
    with pytest.raises(ValueError):
        AsyncInferenceServer(fill_policy="truncate")
    with pytest.raises(ValueError):
        AsyncInferenceServer(max_queue=0)


# ---------------------------------------------------------------------------
# metrics layer
# ---------------------------------------------------------------------------

def test_percentile_and_histogram():
    assert percentile([], 99) == 0.0
    assert percentile([5.0], 50) == 5.0
    xs = [float(i) for i in range(1, 101)]
    assert percentile(xs, 50) == 50.0
    assert percentile(xs, 99) == 99.0
    assert percentile(xs, 100) == 100.0
    assert percentile(xs, 0) == 1.0
    h = Histogram(window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):      # window keeps last 4
        h.record(v)
    assert h.count == 6 and h.max == 6.0
    assert h.percentile(50) == 4.0                # over {3,4,5,6}
    assert h.mean == pytest.approx(21 / 6)
    with pytest.raises(ValueError):
        Histogram(window=0)


def test_serve_metrics_snapshot_shape():
    m = ServeMetrics()
    m.on_submit(queue_depth=3)
    m.on_batch(n_requests=2, cap=4, queue_depth=1)
    m.on_complete(0.25, queue_wait_s=0.1)
    m.on_shed("queue-full")
    m.on_warmup(1, 2)
    snap = m.snapshot()
    assert snap["submitted"] == 1 and snap["completed"] == 1
    assert snap["batches"] == 1 and snap["shed"] == {"queue-full": 1}
    assert snap["shed_total"] == 1 and m.shed_count == 1
    assert snap["warmup"] == dict(done=1, total=2)
    assert snap["latency_s"]["p50"] == 0.25
    assert snap["batch_fill"]["p50"] == 0.5
    for family in ("latency_s", "queue_wait_s", "batch_fill", "queue_depth"):
        assert set(snap[family]) == {"count", "mean", "max",
                                     "p50", "p90", "p99"}
    assert "queue-full" in m.to_json()
