"""The readers of the program's spans and counters: a traced CPU run
reports them, the ones that need a card's completion times stay silent
off it, a program without the recorder gives nothing and raises nothing,
and the interval arithmetic behind the device's idle split holds by
hand."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnbench import cell as C
from gnnbench import run as R
from gnnbench import spanread

CPU = torch.device("cpu")
SPAN_METRICS = ("batch_service_ms", "host_tiling_ms", "bind_ms", "tail_queue_ms")
CARD_ONLY = ("device_trail_ms", "idle_in_batch")
NEW = [m["name"] for m in C.load_benchmark()["per_layer"]
       if m["name"].split(".")[0] in SPAN_METRICS + CARD_ONLY + ("src_rows",)]


@pytest.mark.parametrize("name,suffix", [("gat2-subgraph-open", "serve"),
                                         ("gcn2-subgraph-open", "serve_rate")])
def test_a_traced_serving_run_reads_the_program_spans(name, suffix, small):
    cell = small(C.load_cell(name))
    res = R.execute(cell, 2**31 + 3, 1.0, True, CPU, t0=0.0)
    assert res["correct"]
    got = res["metrics"]
    for m in SPAN_METRICS:
        assert got[f"{m}.{suffix}"]["value"] > 0, m
    assert not any(k.startswith(CARD_ONLY) for k in got)
    # a worker's batch holds its tiling and its bind
    assert got[f"batch_service_ms.{suffix}"]["value"] > got[f"bind_ms.{suffix}"]["value"]
    rec = spanread.export()
    batches = spanread.named(rec, "serve.batch")
    assert len(spanread.named(rec, "serve.queue")) == sum(b["real"] for b in batches)


def test_a_traced_whole_graph_run_counts_padded_source_rows(small):
    cell = small(C.load_cell("gcn2-dblp-whole"))
    res = R.execute(cell, 7, 1.0, True, CPU, t0=0.0)
    ratio = res["metrics"]["src_rows.pass"]["value"]
    c = spanread.export()["counters"]
    assert c["runner.vertices"] == 16 * 3000             # the traced passes
    assert ratio == c["runner.src_rows_padded"] / c["runner.vertices"]
    assert c["runner.src_rows_real"] <= c["runner.src_rows_padded"]
    assert ratio >= 1.0
    assert "src_rows.pass" in {m.name for m in cell.per_layer}


def test_without_the_recorder_the_readers_give_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)   # import fails
    reading = dict(profile=SimpleNamespace(gaps=np.array([[0, 10]], np.int64)))
    for name in NEW:
        reader = C.import_file(C.HERE / "metrics" / f"{name}.py")
        assert reader.read(reading) is None, name


def _span(i, name, start, end, parent=None, tid=1, **ids):
    return dict(ids, id=i, name=name, start_ns=start, end_ns=end, parent=parent,
                tid=tid, cpu_ns=end - start)


def test_idle_time_is_split_by_batch_and_innermost_span(monkeypatch):
    # batch 0 on thread 1 from 0 to 100 (device done at 130), its tile 10-40;
    # batch 1 on thread 2 from 50 to 90 (device done at 95); device idle
    # 20-60, 120-140 and 150-200
    rec = {"counters": {}, "spans": [
        _span(0, "serve.batch", 0, 100, batch=0, device_end_ns=130),
        _span(1, "engine.tile", 10, 40, parent=0, batch=0),
        _span(2, "serve.batch", 50, 90, tid=2, batch=1, device_end_ns=95),
        dict(id=3, name="serve.queue", start_ns=-50, end_ns=0, parent=None,
             tid=1, cpu_ns=None, batch=0, request=0)]}
    gaps = np.array([[20, 60], [120, 140], [150, 200]], np.int64)
    monkeypatch.setattr(spanread, "export", lambda: rec)
    # covered: 20-60 (40) and 120-130 (10) of 110
    share = spanread.idle_in_batch({"profile": SimpleNamespace(gaps=gaps)})
    assert share == pytest.approx(100 * 50 / 110)
    split = spanread.idle_by_span(rec, gaps)
    # 20-40 the tile alone; 40-50 the batch's own time; 50-60 both batches;
    # 120-140 and 150-200 no span open
    assert split == pytest.approx({"engine.tile": 20e-9, "serve.batch": 20e-9,
                                   spanread.NO_BATCH: 70e-9})
    assert sum(split.values()) == pytest.approx(110e-9)


def test_the_tail_is_read_from_its_slowest_requests(monkeypatch):
    # 20 requests in batches 0 (done at 100) and 1 (done at 1,000); the
    # slowest (at or over the 95th percentile) waited 900 and 700 ns
    spans = [_span(100, "serve.batch", 0, 100, batch=0),
             _span(101, "serve.batch", 0, 1000, batch=1)]
    for r in range(18):
        spans.append(_span(r, "serve.queue", 50, 60, batch=0, request=r))
    spans.append(_span(18, "serve.queue", 0, 900, batch=1, request=18))
    spans.append(_span(19, "serve.queue", 100, 800, batch=1, request=19))
    monkeypatch.setattr(spanread, "export", lambda: {"spans": spans, "counters": {}})
    assert spanread.tail_queue_ms() == pytest.approx(800e-6)
