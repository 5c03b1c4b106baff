"""The port's span and counter recorder (`repro_torch.spans`) on the CPU:
off it records nothing and changes no output; spans nest, on the
profiler's clock; the serving tier records one `serve.queue` span a
request and one `serve.batch` span a batch, on the server's own stamps;
the runner counts the source rows its batches compute over.  Every
`result()` and `close()` is bounded by a timeout."""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.core import compiler as tcompiler
from repro_torch.core.pipeline import PipelinedRunner
from repro_torch.core.tiling import build_tiles, grid_tile
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.serve import AsyncInferenceServer, InferenceServer

DIM = 8
CLOSE_S = 60


@pytest.fixture
def recorder():
    """The recorder cleared and on; off again afterwards."""
    spans.enable()
    try:
        yield spans
    finally:
        spans.disable()


def _requests(tr, sizes, seed0=0):
    gs = [tgraphs.random_graph(v, e, seed=seed0 + k, model="powerlaw")
          for k, (v, e) in enumerate(sizes)]
    return gs, [tmodels.init_inputs(tr, g, seed=seed0 + k) for k, g in enumerate(gs)]


def _by_name(rec, name):
    return [s for s in rec["spans"] if s["name"] == name]


def _serve_batch(name):
    tr = tmodels.trace_named(name, DIM, DIM)
    srv = InferenceServer(tcompiler.compile_gnn(tr), tmodels.init_params(tr),
                          device="cpu")
    gs, ins = _requests(tr, [(40, 150), (40, 150), (300, 1200)], seed0=7)
    return [out[0] for out in srv.submit(gs, ins)]


def _whole_graph(name):
    tr = tmodels.trace_stacked(name, 2, DIM, DIM, DIM)
    g = tgraphs.random_graph(200, 900, seed=3, model="powerlaw")
    tiles, ro = build_tiles(g, 3, 3, n_buckets=2, layout="csr")
    runner = PipelinedRunner(tcompiler.compile_gnn(tr), ro.graph, tiles,
                             reordering=ro, device="cpu")
    ins = tmodels.init_inputs(tr, g, seed=4)
    params = tmodels.init_params(tr)
    return [runner(ins, params)[0] for _ in range(2)]


@pytest.mark.parametrize("path", ["serve", "whole"])
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_off_records_nothing_and_on_changes_no_output(path, name):
    run = _serve_batch if path == "serve" else _whole_graph
    spans.enable()
    spans.disable()                        # an empty stretch, now off
    off = run(name)
    assert spans.export() == {"spans": [], "counters": {}}
    spans.enable()
    try:
        on = run(name)
    finally:
        spans.disable()
    rec = spans.export()
    assert _by_name(rec, "runner.run") and rec["counters"]["runner.vertices"] > 0
    for a, b in zip(off, on):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_spans_nest_and_self_time_is_duration_less_children(recorder):
    def work(tag):
        with spans.span("outer", batch=tag):
            time.sleep(0.002)
            with spans.span("mid"):
                time.sleep(0.002)
                with spans.span("inner", batch=-1):
                    time.sleep(0.002)
            with spans.span("mid"):
                pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    rec = spans.export()
    by_id = {s["id"]: s for s in rec["spans"]}
    assert len(by_id) == 12
    own = spans.self_ns(rec["spans"])
    for s in rec["spans"]:
        kids = [c for c in rec["spans"] if c["parent"] == s["id"]]
        dur = s["end_ns"] - s["start_ns"]
        assert own[s["id"]] == dur - sum(c["end_ns"] - c["start_ns"] for c in kids)
        for c in kids:                  # nested in time, on the same thread
            assert s["start_ns"] <= c["start_ns"] <= c["end_ns"] <= s["end_ns"]
            assert c["tid"] == s["tid"]
        if s["name"] == "outer":
            assert s["parent"] is None and len(kids) == 2
            assert own[s["id"]] >= 1_500_000          # its own sleep
        elif s["name"] == "mid":
            assert by_id[s["parent"]]["name"] == "outer"
            assert s["batch"] == by_id[s["parent"]]["batch"]   # inherited
        else:
            assert s["batch"] == -1 and by_id[s["parent"]]["name"] == "mid"
        assert 0 <= s["cpu_ns"]


def test_every_served_request_has_one_queue_span_naming_its_batch(recorder):
    tr = tmodels.trace_named("gcn", DIM, DIM)
    srv = AsyncInferenceServer(default_deadline_s=30.0, dispatch_margin_s=0.05,
                               n_workers=2).start()
    try:
        srv.register_model("gcn", tcompiler.compile_gnn(tr),
                           tmodels.init_params(tr), max_batch=4, device="cpu")
        # two size classes; 5 + 3 requests: full and partial batches
        gs, ins = _requests(tr, [(32, 120)] * 5 + [(150, 600)] * 3)
        tickets = srv.submit_many(gs, ins, deadline_s=2.0)
        for t in tickets:
            t.result(timeout=60)
            assert t.ok
    finally:
        srv.close(timeout=CLOSE_S)
    rec = spans.export()
    queue, batch = _by_name(rec, "serve.queue"), _by_name(rec, "serve.batch")
    assert sorted(s["request"] for s in queue) == list(range(len(gs)))
    batches = {s["batch"]: s for s in batch}
    assert len(batches) == len(batch) == srv.metrics.snapshot()["batches"]
    assert all(s["batch"] in batches for s in queue)
    assert sum(b["real"] for b in batch) == len(gs)
    assert all(b["padded"] == 4 for b in batch)
    # the server's stamps: the spans' queue waits are ServeMetrics' samples
    waits = sorted((s["end_ns"] - s["start_ns"]) / 1e9 for s in queue)
    np.testing.assert_allclose(waits, sorted(srv.metrics.queue_wait._samples),
                               rtol=0, atol=2e-9)
    for t, s in zip(tickets, sorted(queue, key=lambda s: s["request"])):
        assert round((t.t_dispatch - t.t_enqueue) * 1e9) == pytest.approx(
            s["end_ns"] - s["start_ns"], abs=2)
    # each batch's stages sit in it, carry its id, and fit in its time
    kids = {}
    for s in rec["spans"]:
        if s["name"].startswith(("engine.", "runner.")):
            assert s["batch"] in batches
            if s["parent"] == batches[s["batch"]]["id"]:
                kids[s["batch"]] = (kids.get(s["batch"], 0)
                                    + s["end_ns"] - s["start_ns"])
    for b in batch:
        assert kids[b["batch"]] <= b["end_ns"] - b["start_ns"]
        assert "device_end_ns" not in b                     # no card
    for name in ("engine.merge", "engine.tile", "engine.tile_wait",
                 "engine.inputs", "engine.cache", "runner.bind", "runner.run"):
        assert len(_by_name(rec, name)) == len(batch), name
    assert rec["counters"]["engine.h2d_tensors"] == len(batch) * len(ins[0])
    assert rec["counters"]["runner.h2d_bytes"] > 0


def _hand_graph():
    # 8 vertices on a 2 x 2 grid (parts {0..3}, {4..7}); the distinct
    # sources of each tile: (dst 0, src 0) {0, 1, 2}, (0, 1) {5, 6, 7},
    # (1, 0) {0}, (1, 1) {4, 7}: 9 rows, in 4 tiles padded to 8 slots
    src = np.array([0, 1, 2, 5, 6, 7, 7, 4, 0], np.int32)
    dst = np.array([1, 2, 3, 3, 0, 0, 6, 5, 7], np.int32)
    return tgraphs.Graph(src=src, dst=dst, n_vertices=8)


@pytest.mark.parametrize("name", ["gcn", "gat"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_source_row_counters_by_hand(name, bucketed, recorder):
    g = _hand_graph()
    tiles = (build_tiles(g, 2, 2, n_buckets=2)[0] if bucketed
             else grid_tile(g, 2, 2, sparse=True))
    tr = tmodels.trace_named(name, DIM, DIM)
    runner = PipelinedRunner(tcompiler.compile_gnn(tr), g, tiles, device="cpu")
    ins, params = tmodels.init_inputs(tr, g, seed=1), tmodels.init_params(tr)
    spans.enable()
    for _ in range(3):
        runner(ins, params)
    c = spans.export()["counters"]
    # every batch that runs has 4 x 8 slots over its tiles: one batch of 4
    # tiles, or two buckets of 2 (gcn's SpMM), or the unbucketed softmax
    # batch alone (gat)
    assert c["runner.src_rows_padded"] == 3 * 4 * 8
    assert c["runner.src_rows_real"] == 3 * 9
    assert c["runner.vertices"] == 3 * 8
    assert c["runner.h2d_tensors"] > 0          # bound once, at the first run


def _hand_graph_isolated():
    # the hand graph's edges on 40 vertices (parts {0..19}, {20..39}),
    # vertices 4..7 moved to 20..23: the same 4 tiles of 8 slots, 32 padded
    # rows, now fewer than the vertices
    g = _hand_graph()
    move = np.where(np.arange(8) < 4, np.arange(8), np.arange(8) + 16)
    return tgraphs.Graph(src=move[g.src].astype(np.int32),
                         dst=move[g.dst].astype(np.int32), n_vertices=40)


@pytest.mark.parametrize("name", ["gcn", "gat"])
@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("isolated", [False, True], ids=["flat", "per_slot"])
def test_computed_source_row_counter_by_hand(name, bucketed, isolated,
                                             recorder):
    g = _hand_graph_isolated() if isolated else _hand_graph()
    tiles = (build_tiles(g, 2, 2, n_buckets=2)[0] if bucketed
             else grid_tile(g, 2, 2, sparse=True))
    tr = tmodels.trace_named(name, DIM, DIM)
    runner = PipelinedRunner(tcompiler.compile_gnn(tr), g, tiles, device="cpu")
    ins, params = tmodels.init_inputs(tr, g, seed=1), tmodels.init_params(tr)
    spans.enable()
    for _ in range(3):
        runner(ins, params)
    c = spans.export()["counters"]
    assert c["runner.src_rows_padded"] == 3 * 4 * 8
    # one phase with tile work, whose source block computes one node (gcn's
    # transform, gat's source score): over the 8 vertices of the flat
    # store, or over the 32 slots of the batches where 40 vertices are more
    assert c["runner.src_rows_computed"] == 3 * (32 if isolated else 8)
    assert c["runner.vertices"] == 3 * (40 if isolated else 8)


@pytest.mark.parametrize("explicit", [False, True])
def test_spans_are_on_the_profilers_clock(explicit):
    if explicit:
        spans.enable()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with spans.span("clocked"):
            with record_function("clocked.range"):
                torch.ones(4).sum()
    finally:
        prof.stop()
        spans.disable()
    (mine,) = _by_name(spans.export(), "clocked")
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "clocked.range"]
    assert len(starts) == 1
    assert abs(starts[0] - mine["start_ns"]) < 1_000_000


def test_a_profiler_trace_starts_a_stretch_and_its_end_ends_it():
    spans.enable()
    spans.disable()
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("during"):
            spans.count("during.n", 2)
    with spans.span("after"):
        spans.count("during.n", 5)
    rec = spans.export()
    assert [s["name"] for s in rec["spans"]] == ["during"]
    assert rec["counters"] == {"during.n": 2}


def test_counters_hold_every_add_from_many_threads(recorder):
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [spans.count("n", 3)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert spans.export()["counters"]["n"] == 16 * 2000 * 3
